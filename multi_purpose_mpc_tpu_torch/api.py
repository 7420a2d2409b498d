"""Reference-mirroring object API (port of ``multi_purpose_mpc_tpu/api.py``).

Users of the reference drive four classes — ``Map``, ``ReferencePath``,
``BicycleModel``, ``MPC`` (plus ``Obstacle`` and ``LidarModel``) — through
the two-call loop of its README.md:72::

    u = mpc.get_control()
    car.drive(u)

The classes keep the reference's constructor signatures, methods and
properties (map.py:45, reference_path.py:66, spatial_bicycle_models.py:322,
MPC.py:15, lidar_model.py:14).  Each is a thin host-side wrapper owning
tensors on one device: the card unless ``Map(..., device=...)`` names
another, and every other object takes the device of the ``Map`` it is
built on.  ``get_control`` runs :func:`~.mpc.mpc_step` on the live grid —
on the card kernel K4 (scanline occupancy), the free runs, kernel K2
(corridor selection), the assembly and kernel K3 (the ADMM solve) — and
copies its results to the host once.  For throughput use
:mod:`multi_purpose_mpc_tpu_torch.simulation`, which steps whole fleets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, MPCConfig,
                                                ModelConfig, PathConfig,
                                                SolverConfig,
                                                SpeedProfileConstraints)
from multi_purpose_mpc_tpu_torch.models import bicycle as bike
from multi_purpose_mpc_tpu_torch.models.bicycle import CarState, init_car_state
from multi_purpose_mpc_tpu_torch.mpc import mpc_step, predict_world_positions
from multi_purpose_mpc_tpu_torch.ops import constraints as cons
from multi_purpose_mpc_tpu_torch.ops import grid as grid_ops
from multi_purpose_mpc_tpu_torch.ops import lidar as lidar_ops
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import init_solver_carry
from multi_purpose_mpc_tpu_torch.ops.path import PathData, build_reference_path
from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu_torch.utils import graphs
from multi_purpose_mpc_tpu_torch.utils import maps as maps_util
from multi_purpose_mpc_tpu_torch.utils import viz
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, rebuild, tree_map

_F32 = torch.float32


def _host_occ(grid: grid_ops.GridMap) -> np.ndarray:
    """The reference's int8 ``Map.data`` from a grid (one device copy)."""
    return grid.occ.to(torch.int8).cpu().numpy()


class Obstacle:
    """Circular obstacle (reference: map.py:16-37)."""

    def __init__(self, cx: float, cy: float, radius: float):
        self.cx = cx
        self.cy = cy
        self.radius = radius

    def show(self, ax=None):
        import matplotlib.pyplot as plt

        viz.plot_obstacles(ax or plt.gca(), [(self.cx, self.cy, self.radius)])


class Map:
    """Occupancy-grid map (reference: map.py:44-155).

    ``data`` is the binary numpy grid (1 = free, 0 = occupied) like the
    reference's; the :class:`~.ops.grid.GridMap` twin on ``device`` is
    what the control step reads, and ``data`` is refreshed from it after
    every change."""

    def __init__(self, file_path: str, origin, resolution: float,
                 threshold_occupied: int = 100, device="cuda"):
        self.file_path = file_path
        self.origin = origin
        self.resolution = resolution
        self.threshold_occupied = threshold_occupied

        data = maps_util.load_map_image(file_path, threshold_occupied)
        self.data = data
        self.height, self.width = data.shape
        self.obstacles: list[Obstacle] = []
        self.boundaries: list = []
        self._grid = grid_ops.make_grid_map(data.astype(np.float32), origin,
                                            resolution, device=device)

    @property
    def grid(self) -> grid_ops.GridMap:
        return self._grid

    @property
    def device(self) -> torch.device:
        return self._grid.device

    def w2m(self, x: float, y: float):
        """World -> pixel (reference: map.py:77-88), float64 host math."""
        dx = int(np.floor((x - self.origin[0]) / self.resolution))
        dy = int(np.floor((y - self.origin[1]) / self.resolution))
        return dx, dy

    def m2w(self, dx: int, dy: int):
        """Pixel -> world cell center (reference: map.py:90-101)."""
        x = (dx + 0.5) * self.resolution + self.origin[0]
        y = (dy + 0.5) * self.resolution + self.origin[1]
        return x, y

    def add_obstacles(self, obstacles: Sequence[Obstacle]) -> None:
        """Rasterize circular obstacles (reference: map.py:116-137)."""
        self.obstacles.extend(obstacles)
        obs = [(o.cx, o.cy, o.radius) for o in obstacles]
        self._grid = maps_util.add_obstacles_host(self._grid, self.origin,
                                                  self.resolution, obs)
        self.data = _host_occ(self._grid)

    def add_boundary(self, boundaries: Sequence) -> None:
        """Rasterize line boundaries (reference: map.py:139-155)."""
        self.boundaries.extend(boundaries)
        starts = [b[0] for b in boundaries]
        ends = [b[1] for b in boundaries]
        self._grid = grid_ops.add_boundary(self._grid, starts, ends)
        self.data = _host_occ(self._grid)


class Waypoint:
    """Read-only view of one row of the struct-of-arrays path (reference
    Waypoint object: reference_path.py:20-57), read from the host copies
    the :class:`ReferencePath` keeps."""

    __slots__ = ("_rp", "_i")

    def __init__(self, rp: "ReferencePath", i: int):
        object.__setattr__(self, "_rp", rp)
        object.__setattr__(self, "_i", i)

    def _np(self, field):
        return self._rp._host[field]

    @property
    def x(self):
        return float(self._np("x")[self._i])

    @property
    def y(self):
        return float(self._np("y")[self._i])

    @property
    def psi(self):
        return float(self._np("psi")[self._i])

    @property
    def kappa(self):
        return float(self._np("kappa")[self._i])

    @property
    def v_ref(self):
        return float(self._np("v_ref")[self._i])

    @property
    def lb(self):
        return float(self._np("lb")[self._i])

    @property
    def ub(self):
        return float(self._np("ub")[self._i])

    @property
    def static_border_cells(self):
        bu = self._np("border_ub")[self._i]
        bl = self._np("border_lb")[self._i]
        return (tuple(bu.tolist()), tuple(bl.tolist()))

    @property
    def dynamic_border_cells(self):
        cells = self._rp._dynamic_border_cells
        if cells is None or self._i not in cells:
            return self.static_border_cells
        bu, bl = cells[self._i]
        return (tuple(bu), tuple(bl))

    def __sub__(self, other: "Waypoint") -> float:
        """Euclidean distance (reference: reference_path.py:50-57)."""
        return math.hypot(self.x - other.x, self.y - other.y)


_HOST_FIELDS = ("x", "y", "psi", "kappa", "v_ref", "lb", "ub", "border_ub",
                "border_lb")


class ReferencePath:
    """Reference path (reference: reference_path.py:65-648), on the device
    of ``map``."""

    def __init__(self, map: Map, wp_x, wp_y, resolution: float,
                 smoothing_distance: int, max_width: float, circular: bool):
        self.map = map
        self.eps = 1e-12
        self.resolution = resolution
        self.smoothing_distance = smoothing_distance
        self.circular = circular

        cfg = PathConfig(wp_x=tuple(wp_x), wp_y=tuple(wp_y),
                         resolution=resolution,
                         smoothing_distance=smoothing_distance,
                         max_width=max_width, circular=circular)
        self.path_data = build_reference_path(map.grid, cfg)
        self.n_waypoints = self.path_data.n_wp
        self.length = float(self.path_data.length)
        self.segment_lengths = self._host["seg_len"].tolist()
        self._dynamic_border_cells = None

    @property
    def path_data(self) -> PathData:
        return self._path_data

    @path_data.setter
    def path_data(self, path: PathData) -> None:
        """Set the path and refresh the host copies :class:`Waypoint` reads
        (one device copy per field, not one per property access)."""
        self._path_data = path
        self._host = {f: getattr(path, f).cpu().numpy()
                      for f in _HOST_FIELDS + ("seg_len",)}

    @property
    def waypoints(self):
        return [Waypoint(self, i) for i in range(self.n_waypoints)]

    def get_waypoint(self, wp_id: int) -> Waypoint:
        """Circular indexing; clamps at the end of non-circular paths
        instead of exiting (reference_path.py:356-371)."""
        if wp_id >= self.n_waypoints:
            if self.circular:
                wp_id = wp_id % self.n_waypoints
            else:
                wp_id = self.n_waypoints - 1
        return Waypoint(self, wp_id)

    def compute_speed_profile(self, Constraints) -> None:
        """Curvature-limited speed profile (reference_path.py:289-354).
        ``Constraints``: SpeedProfileConstraints or the reference's dict."""
        if isinstance(Constraints, dict):
            Constraints = SpeedProfileConstraints(
                a_min=Constraints["a_min"], a_max=Constraints["a_max"],
                v_min=Constraints["v_min"], v_max=Constraints["v_max"],
                ay_max=Constraints["ay_max"])
        self.path_data = compute_speed_profile(self.path_data, Constraints)

    def update_path_constraints(self, wp_id: int, N: int, min_width: float,
                                safety_margin: float):
        """Dynamic corridor of the map as it is now (reference_path.py:
        522-648), through :func:`~.ops.constraints.update_path_constraints`.
        Returns (ub, lb, border_cells) like the reference."""
        cor = cons.update_path_constraints(self.map.grid, self.path_data,
                                           wp_id, N, min_width, safety_margin)
        ub, lb, bu, bl = (t[0].cpu().numpy() for t in cor)
        cells = [((bu[i][0], bu[i][1]), (bl[i][0], bl[i][1])) for i in range(N)]
        # the reference stores the dynamic border cells on its waypoints
        # (reference_path.py:646) for show()
        if self._dynamic_border_cells is None:
            self._dynamic_border_cells = {}
        for k in range(N):
            idx = (wp_id + k) % self.n_waypoints
            self._dynamic_border_cells[idx] = (tuple(bu[k]), tuple(bl[k]))
        return ub, lb, cells

    def show(self, display_drivable_area: bool = True, ax=None):
        """Render map + path + borders + dynamic corridor
        (reference_path.py:373-464)."""
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        viz.plot_map(ax, self.map.grid)
        viz.plot_path(ax, self.path_data, display_drivable_area)
        # dynamic corridor (orange): the border cells stored by
        # update_path_constraints, the static ones where never updated
        # (reference_path.py:445-460, 47-48)
        if display_drivable_area and self._dynamic_border_cells is not None:
            bu = self._host["border_ub"].copy()
            bl = self._host["border_lb"].copy()
            for idx, (u, l) in self._dynamic_border_cells.items():
                bu[idx] = u
                bl[idx] = l
            viz.plot_corridor(ax, bu, bl)
        viz.plot_obstacles(ax, [(o.cx, o.cy, o.radius) for o in self.map.obstacles])
        return ax


class TemporalState:
    """(x, y, psi) view (reference: spatial_bicycle_models.py:25-46)."""

    def __init__(self, x=0.0, y=0.0, psi=0.0):
        self.x = x
        self.y = y
        self.psi = psi


class SimpleSpatialState:
    """(e_y, e_psi, t) view (reference: spatial_bicycle_models.py:94-109)."""

    def __init__(self, e_y=0.0, e_psi=0.0, t=0.0):
        self.e_y = e_y
        self.e_psi = e_psi
        self.t = t

    def __getitem__(self, i):
        return [self.e_y, self.e_psi, self.t][i]

    def __len__(self):
        return 3


class BicycleModel:
    """Spatial kinematic bicycle (reference: spatial_bicycle_models.py:322-417).

    Owns a :class:`CarState` with a batch axis of 1 on the path's device;
    ``drive`` runs the nonlinear plant step there."""

    def __init__(self, reference_path: ReferencePath, length: float,
                 width: float, Ts: float):
        self.reference_path = reference_path
        self.length = length
        self.width = width
        self.Ts = Ts
        self.n_states = 3
        self.eps = 1e-12
        self.safety_margin = width / math.sqrt(2.0)
        self._model_cfg = ModelConfig(length=length, width=width, Ts=Ts)
        self._N = 30  # replaced when an MPC attaches
        self._state: CarState = init_car_state(reference_path.path_data, self._N)

    # --- state views -------------------------------------------------
    @property
    def state(self) -> CarState:
        return self._state

    def _scalars(self, *fields):
        """Lane 0's ``fields`` as Python numbers, in one device copy."""
        vals = torch.stack([getattr(self._state, f)[0].float() for f in fields])
        return vals.cpu().tolist()

    @property
    def temporal_state(self) -> TemporalState:
        return TemporalState(*self._scalars("x", "y", "psi"))

    @property
    def spatial_state(self) -> SimpleSpatialState:
        e_y, e_psi = self._scalars("e_y", "e_psi")
        return SimpleSpatialState(e_y, e_psi, 0.0)

    @property
    def s(self) -> float:
        return float(self._state.s[0])

    @property
    def wp_id(self) -> int:
        return int(self._state.wp_id[0])

    @property
    def current_waypoint(self) -> Waypoint:
        return Waypoint(self.reference_path, self.wp_id)

    def _device_scalar(self, v, dtype=_F32) -> torch.Tensor:
        return torch.tensor([v], dtype=dtype, device=self._state.x.device)

    # --- reference methods --------------------------------------------
    def t2s(self, reference_waypoint: Waypoint, reference_state):
        e_y, e_psi = bike.t2s(self.reference_path.path_data,
                              self._device_scalar(reference_waypoint._i,
                                                  torch.int32),
                              self._device_scalar(reference_state.x),
                              self._device_scalar(reference_state.y),
                              self._device_scalar(reference_state.psi))
        return SimpleSpatialState(float(e_y[0]), float(e_psi[0]), 0.0)

    def s2t(self, reference_waypoint: Waypoint, reference_state):
        x, y, psi = bike.s2t(self.reference_path.path_data,
                             self._device_scalar(reference_waypoint._i,
                                                 torch.int32),
                             self._device_scalar(reference_state[0]),
                             self._device_scalar(reference_state[1]))
        return TemporalState(float(x[0]), float(y[0]), float(psi[0]))

    def get_current_waypoint(self) -> None:
        wp = bike.locate_waypoint(self.reference_path.path_data,
                                  self._state.s)
        self._state = dataclasses.replace(self._state, wp_id=wp)

    def set_pose(self, x: float, y: float, psi: float,
                 s: Optional[float] = None) -> None:
        """Inject an external pose estimate (the ROS-adaptation seam: the
        real car's pose came from a localization topic, README.md:76).

        Re-localizes on the path and refreshes the spatial state; ``s`` can
        be given directly when the estimator tracks arc length itself.
        """
        pd = self.reference_path.path_data
        st = dataclasses.replace(self._state, x=self._device_scalar(x),
                                 y=self._device_scalar(y),
                                 psi=self._device_scalar(psi))
        if s is not None:
            st = dataclasses.replace(st, s=self._device_scalar(s))
        else:
            # nearest waypoint by euclidean distance, then arc length there
            d2 = (pd.x - st.x) ** 2 + (pd.y - st.y) ** 2
            wp = torch.argmin(d2).reshape(1).to(torch.int32)
            st = dataclasses.replace(st, s=pd.cum_len[wp.long()], wp_id=wp)
        wp = bike.locate_waypoint(pd, st.s)
        e_y, e_psi = bike.t2s(pd, wp, st.x, st.y, st.psi)
        self._state = dataclasses.replace(st, wp_id=wp, e_y=e_y, e_psi=e_psi)

    def drive(self, u) -> None:
        """Apply [v, delta] for one Ts (reference:
        spatial_bicycle_models.py:221-244)."""
        vd = torch.tensor([float(u[0]), float(u[1])], dtype=_F32,
                          device=self._state.x.device)
        self._state = bike.drive(self._state, self.reference_path.path_data,
                                 vd[:1], vd[1:], self.length, self.Ts)

    def show(self, ax=None):
        import matplotlib.pyplot as plt

        x, y, psi = self._scalars("x", "y", "psi")
        viz.plot_car(ax or plt.gca(), x, y, psi, self.length, self.width)


class _Graphed:
    """``fn(*args)`` (trees of tensors) replayed as a CUDA graph on static
    copies of ``args``: captured at the first call and again when an
    argument's shape or dtype, or an object of ``key``, changes.  ``key``
    names by identity everything else the step reads (the path, the
    configs, the grid's geometry); the graph holds it while it lives, so
    the tensors whose addresses the capture baked in stay alive.  A call
    copies ``args`` into the copies, replays and returns the graph's own
    outputs, which the next call rewrites; a call that captures returns
    its warm-up's result, the step run eagerly.  ``prepare(*copies)``
    runs once before each capture (set-up that must not run inside the
    warm-up's sync check)."""

    def __init__(self, fn):
        self.fn = fn
        self.key = self.copies = self.graph = None

    def __call__(self, key, prepare, *args):
        flat = leaves(args)
        layout = [(x.shape, x.dtype) for x in flat]
        if self.graph is None or layout != self.key[1] or len(key) != len(
                self.key[0]) or any(a is not b for a, b in zip(key, self.key[0])):
            self.graph = None  # frees the old graph's memory pool first
            self.copies = [x.clone(memory_format=torch.contiguous_format)
                           for x in flat]
            static = rebuild(args, self.copies)
            if prepare is not None:
                prepare(*static)
            step = lambda: self.fn(*static)
            self.graph = graphs.StepGraph(step, warmup=step)
            self.key = (tuple(key), layout)
            return self.graph.first
        for buf, x in zip(self.copies, flat):
            buf.copy_(x)
        self.graph.replay()
        return self.graph.out


def _diag(M, n):
    """A cost diagonal from ndarray / scipy-sparse-like input."""
    M = np.asarray(M.todense()) if hasattr(M, "todense") else np.asarray(M)
    if M.ndim == 2:
        M = np.diagonal(M)
    return tuple(float(v) for v in M.reshape(-1)[:n])


class MPC:
    """LTV-MPC controller (reference: MPC.py:14-257)."""

    def __init__(self, model: BicycleModel, N: int, Q, R, QN,
                 StateConstraints: dict, InputConstraints: dict,
                 ay_max: float, solver: Optional[SolverConfig] = None):
        self.model = model
        self.N = N
        self.nx = 3
        self.nu = 2

        umin = np.asarray(InputConstraints["umin"], np.float64)
        umax = np.asarray(InputConstraints["umax"], np.float64)
        xmin = np.asarray(StateConstraints["xmin"], np.float64)
        xmax = np.asarray(StateConstraints["xmax"], np.float64)
        delta_max = math.atan(float(umax[1]) * model.length)

        self.config = MPCConfig(
            N=N, Q=_diag(Q, 3), R=_diag(R, 2), QN=_diag(QN, 3),
            v_max=float(umax[0]), v_min=float(umin[0]), delta_max=delta_max,
            ay_max=ay_max, xmin=tuple(xmin.tolist()), xmax=tuple(xmax.tolist()),
            solver=solver or SolverConfig())
        # size the model's cached control sequence and solver carry for
        # this horizon
        dev = model.reference_path.map.device
        model._N = N
        model._state = dataclasses.replace(
            model._state, u_seq=torch.zeros((1, N * 2), dtype=_F32, device=dev),
            solver=init_solver_carry(N, 1, device=dev))

        self.current_prediction = None
        self.current_control = np.zeros(self.nu * N)
        self.infeasibility_counter = 0
        self._graphed = _Graphed(self._control_step)

    def _control_step(self, state: CarState, grid: grid_ops.GridMap):
        """:func:`~.mpc.mpc_step` and the predicted positions: ``(new
        state, flat)``, ``flat`` everything the host reads, for one
        device-to-host copy."""
        rp = self.model.reference_path
        out = mpc_step(state, rp.path_data, grid, self.config,
                       self.model._model_cfg)
        st = out.state
        xp, yp = predict_world_positions(rp.path_data, st.wp_id, out.X_pred)
        return st, torch.cat([out.v, out.delta, st.failed.to(_F32),
                              st.infeasibility_count.to(_F32), st.u_seq[0],
                              xp[0], yp[0]])

    def get_control(self):
        """One control step; returns np.array([v, delta])
        (reference: MPC.py:161-222).  Raises once the controller has
        failed (N - 1 consecutive infeasible QPs).  On the card the step
        replays a CUDA graph (the counterpart of the JAX API's jitted
        step), captured at the first call and again once the path (as
        ``compute_speed_profile`` replaces it), a config or the grid's
        geometry is replaced; the one device-to-host copy stays outside
        it."""
        rp = self.model.reference_path
        grid = rp.map.grid
        if graphs.should_capture(grid.device):
            cfg = self.config
            # the corridor's tables (setup, cached per path and geometry)
            # are built before the capture's warm-up and its sync check
            prepare = lambda _, g: cons.corridor_tables(
                g, rp.path_data, cfg.N, cfg.n_scan_samples, cfg.max_segments)
            key = (rp.path_data, cfg, self.model._model_cfg, grid.origin,
                   grid.resolution)
            st, flat = self._graphed(key, prepare, self.model._state, grid)
            st = tree_map(torch.clone, st)  # the next replay rewrites st
        else:
            st, flat = self._control_step(self.model._state, grid)
        self.model._state = st
        N = self.N
        flat = flat.cpu().numpy()
        v, delta, failed, count = flat[:4]
        useq = flat[4:4 + 2 * N].reshape(N, 2)
        self.infeasibility_counter = int(count)
        ctrl = useq.copy()
        ctrl[:, 1] = np.arctan(ctrl[:, 1] * self.model.length)
        self.current_control = ctrl.reshape(-1)
        self.current_prediction = (flat[4 + 2 * N:5 + 3 * N],
                                   flat[5 + 3 * N:])
        if failed:
            # the reference exits the process here (MPC.py:218-220)
            raise RuntimeError("No control signal computed! "
                               f"({self.N - 1} consecutive infeasible QPs)")
        return np.array([float(v), float(delta)])

    def update_prediction(self, spatial_state_prediction=None):
        return self.current_prediction

    def show_prediction(self, ax=None):
        import matplotlib.pyplot as plt

        if self.current_prediction is not None:
            viz.plot_prediction(ax or plt.gca(), *self.current_prediction)


class LidarModel:
    """Lidar sensor (reference: lidar_model.py:10-129)."""

    def __init__(self, FoV: float, range: float, resolution: float,
                 conservative: bool = False):
        """``conservative=True`` selects the exact corner-span scan of the
        reference (lidar_model.py:75-108); the default point-samples each
        ray (:func:`~.ops.lidar.scan`)."""
        self.FoV = FoV
        self.range = range
        self.resolution = resolution
        self.conservative = conservative
        self.config = LidarConfig(FoV=FoV, range=range, resolution=resolution)
        self.n_measurements = self.config.n_beams
        angles = lidar_ops.beam_angles(self.config, device="cpu").numpy()
        self.measurements = np.stack(
            [angles, np.full_like(angles, range)], axis=0)
        self._last_scan = None
        self._graphed = _Graphed(self._scan_step)

    @staticmethod
    def _pose(car, device):
        """0-d pose tensors on ``device``: a BicycleModel's own state, or
        the x / y / psi attributes of any pose (e.g. a TemporalState)."""
        if isinstance(car, BicycleModel):
            st = car.state
            return st.x[0], st.y[0], st.psi[0]
        return tuple(torch.tensor(float(getattr(car, f)), dtype=_F32,
                                  device=device) for f in ("x", "y", "psi"))

    def _scan_step(self, grid, x, y, psi):
        out = lidar_ops.scan_rays(grid, x, y, psi, self.config,
                                  conservative=self.conservative)
        return out, lidar_ops.measurements(out)

    def scan(self, car, map: Map):
        """Update ``measurements`` from the car pose (lidar_model.py:37-112).
        ``car``: a BicycleModel or anything with x / y / psi attributes.
        On the card the scan replays a CUDA graph (the counterpart of the
        JAX API's jitted scan), captured at the first call."""
        x, y, psi = self._pose(car, map.device)
        if self.conservative:
            self.config.validate_for_grid(float(map.grid.resolution))
        if graphs.should_capture(map.device):
            out, meas = self._graphed((self.config, self.conservative), None,
                                      map.grid, x, y, psi)
            out = tree_map(torch.clone, out)  # the next replay rewrites it
        else:
            out, meas = self._scan_step(map.grid, x, y, psi)
        self._last_scan = out
        self.measurements = meas.cpu().numpy()
        return self.measurements

    def update_map(self, car, map: Map, clear_free: bool = False) -> None:
        """Write the last scan back into the map (online map update)."""
        if self._last_scan is None:
            return
        x, y, psi = self._pose(car, map.device)
        map._grid = lidar_ops.update_grid_from_scan(
            map.grid, x, y, psi, self._last_scan, self.config,
            clear_free=clear_free)
        map.data = _host_occ(map._grid)

    def plot_scan(self, car, ax=None):
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        pose = car.temporal_state if hasattr(car, "temporal_state") else car
        ang = self.measurements[0] + pose.psi
        ex = pose.x + self.measurements[1] * np.cos(ang)
        ey = pose.y + self.measurements[1] * np.sin(ang)
        for i in range(self.n_measurements):
            ax.plot((pose.x, ex[i]), (pose.y, ey[i]), c="#5DADE2", lw=0.5)
