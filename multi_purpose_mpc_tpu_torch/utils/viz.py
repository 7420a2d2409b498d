"""Post-hoc visualization (port of ``multi_purpose_mpc_tpu/utils/viz.py``).

The closed loop returns logs on the device (:class:`~..simulation.SimLog`)
and this module replays them on the host, in the reference's visual
vocabulary (map canvas, waypoints, static borders, dynamic corridor in
orange, obstacles, car as a rotated rectangle, prediction scatter;
reference_path.py:373-464, spatial_bicycle_models.py:281-307,
MPC.py:250-257).  Inputs are numpy arrays or tensors on any device; a
tensor is copied to the host when a function is called.  matplotlib is
imported inside the functions that draw, never on import.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# Reference color vocabulary (reference_path.py:10-13, MPC.py:7, map.py:9,
# spatial_bicycle_models.py:17-18)
DRIVABLE_AREA = "#BDC3C7"
WAYPOINTS = "#D0D3D4"
PATH_CONSTRAINTS = "#F5B041"
OBSTACLE = "#2E4053"
CAR = "#F1C40F"
CAR_OUTLINE = "#B7950B"
PREDICTION = "#BA4A00"
TRAJECTORY = "#2E86C1"


def _np(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _extent(grid):
    origin = _np(grid.origin)
    ox, oy = float(origin[0]), float(origin[1])
    res = float(_np(grid.resolution))
    h, w = grid.occ.shape
    return [ox, ox + w * res, oy, oy + h * res]


def plot_map(ax, grid, show_occupancy: bool = True):
    """Map canvas (reference_path.py:388-395; we show the actual occupancy
    rather than a blank canvas so obstacles are visible)."""
    occ = _np(grid.occ)
    img = occ if show_occupancy else np.ones_like(occ)
    ax.imshow(img, cmap="gray", origin="lower", extent=_extent(grid),
              vmin=-1.0, vmax=1.0)
    ax.set_xticks([])
    ax.set_yticks([])


def plot_path(ax, path, display_drivable_area: bool = True):
    """Waypoints + static borders (reference_path.py:397-443)."""
    x = _np(path.x)
    y = _np(path.y)
    bub = _np(path.border_ub)
    blb = _np(path.border_lb)

    ax.scatter(x, y, c=WAYPOINTS, s=3, zorder=3)
    if display_drivable_area:
        closed = bool(path.circular)
        for b in (bub, blb):
            bx = np.append(b[:, 0], b[0, 0]) if closed else b[:, 0]
            by = np.append(b[:, 1], b[0, 1]) if closed else b[:, 1]
            ax.plot(bx, by, color="#5E5E5E", lw=1.0, zorder=2)


def plot_corridor(ax, border_ub, border_lb):
    """Dynamic drivable corridor (orange, reference_path.py:445-460)."""
    bu = _np(border_ub)
    bl = _np(border_lb)
    ax.plot(bu[:, 0], bu[:, 1], c=PATH_CONSTRAINTS, lw=1.5, zorder=4)
    ax.plot(bl[:, 0], bl[:, 1], c=PATH_CONSTRAINTS, lw=1.5, zorder=4)


def plot_obstacles(ax, obstacles: Sequence):
    """Circular obstacles (map.py:28-37)."""
    import matplotlib.patches as patches

    for cx, cy, rad in obstacles:
        ax.add_patch(patches.Circle((cx, cy), rad, color=OBSTACLE, zorder=20))


def plot_car(ax, x, y, psi, length, width):
    """Car as a rotated rectangle about its center of gravity
    (spatial_bicycle_models.py:281-307)."""
    import matplotlib.patches as patches

    cog_x = x - (length / 2 * np.cos(psi) - width / 2 * np.sin(psi))
    cog_y = y - (width / 2 * np.cos(psi) + length / 2 * np.sin(psi))
    car = patches.Rectangle((cog_x, cog_y), length, width,
                            angle=np.rad2deg(psi), facecolor=CAR,
                            edgecolor=CAR_OUTLINE, zorder=20)
    ax.add_patch(car)


def plot_prediction(ax, x_pred, y_pred):
    """MPC horizon prediction scatter (MPC.py:250-257)."""
    ax.scatter(_np(x_pred), _np(y_pred), c=PREDICTION, s=10,
               zorder=15)


def render_frame(grid, path, obstacles, log, t: int, model_cfg,
                 prediction=None, ax=None):
    """One animation frame at step ``t`` from a SimLog."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    plot_map(ax, grid)
    plot_path(ax, path)
    plot_obstacles(ax, obstacles)
    x = float(_np(log.x)[t])
    y = float(_np(log.y)[t])
    psi = float(_np(log.psi)[t])
    plot_car(ax, x, y, psi, model_cfg.length, model_cfg.width)
    if prediction is not None:
        plot_prediction(ax, *prediction)
    v = float(_np(log.v)[t])
    d = float(_np(log.delta)[t])
    ax.set_title(f"MPC Simulation: v(t): {v:.2f}, delta(t): {d:.2f}, "
                 f"Duration: {t * model_cfg.Ts:.2f} s")
    ax.axis("off")
    return ax


def render_trajectory(grid, path, obstacles, log, model_cfg,
                      out_path: Optional[str] = None, lanes: int = 1):
    """Whole-run overview: trajectory trace(s) colored by speed."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    plot_map(ax, grid)
    plot_path(ax, path)
    plot_obstacles(ax, obstacles)

    xs = _np(log.x)
    ys = _np(log.y)
    vs = _np(log.v)
    act = _np(log.active)
    if xs.ndim == 1:
        xs, ys, vs, act = (a[:, None] for a in (xs, ys, vs, act))
    for b in range(min(lanes, xs.shape[1])):
        m = act[:, b]
        ax.scatter(xs[m, b], ys[m, b], c=vs[m, b], cmap="viridis", s=4,
                   zorder=10)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def save_animation(grid, path, obstacles, log, model_cfg, out_path: str,
                   stride: int = 2, fps: int = 20):
    """GIF/mp4 replay of a run (animation parity with README.md:25-27)."""
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots(figsize=(6, 6))
    T = len(_np(log.x))
    frames = range(0, T, stride)

    def draw(t):
        ax.clear()
        render_frame(grid, path, obstacles, log, t, model_cfg, ax=ax)
        return []

    anim = animation.FuncAnimation(fig, draw, frames=frames, blit=False)
    anim.save(out_path, fps=fps,
              writer="pillow" if out_path.endswith(".gif") else None)
    plt.close(fig)
