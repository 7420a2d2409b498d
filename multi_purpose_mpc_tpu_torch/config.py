"""Typed configuration, field for field the JAX package's ``config.py``.

The JAX package's configs cannot be imported from here: importing any
``multi_purpose_mpc_tpu`` module runs that package's ``__init__``, which
imports jax and flax.  So the shared dataclasses and presets are copied; a
test pins every shared default and both presets to the originals.

Left out, because they select TPU-only code paths the port does not have:
``SolverConfig.kernel_lanes`` / ``rolled_stage_loops`` (Mosaic lane tiles
and stage-loop schedules) and
``MPCConfig.solver_backend`` / ``extract_backend`` (the port dispatches on
the device a tensor lives on).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Occupancy-grid map metadata (reference: map.py:45-75)."""

    file_path: str
    origin: Tuple[float, float]
    resolution: float  # m / px
    threshold_occupied: int = 100
    hole_area_threshold: int = 5  # px, reference: map.py:113


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Reference-path construction parameters (reference: reference_path.py:66-108)."""

    wp_x: Tuple[float, ...]
    wp_y: Tuple[float, ...]
    resolution: float  # m / waypoint
    smoothing_distance: int
    max_width: float  # m, max drivable width to each side
    circular: bool
    # samples along each static-width ray (fixed K instead of Bresenham)
    n_ray_samples: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Kinematic bicycle parameters (reference: spatial_bicycle_models.py:117-153)."""

    length: float  # m
    width: float  # m
    Ts: float  # s, sampling time

    @property
    def safety_margin(self) -> float:
        # Ellipsoid around the car (reference: spatial_bicycle_models.py:246-254).
        return self.width / math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched ADMM (OSQP-algorithm) solver settings.

    Fixed iteration counts; convergence is a per-lane status value, never an
    exception.  The production budget is 30 iterations x 6 rho rounds + 10
    polish iterations (see the JAX package's config for the measurements
    behind each default).
    """

    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # equality rows use rho * this (OSQP convention)
    alpha: float = 1.6  # over-relaxation
    iterations: int = 30  # ADMM iterations per rho round
    rho_updates: int = 6  # rho-adaptation rounds (refactorize between rounds)
    scaling_iters: int = 10  # Ruiz equilibration sweeps (dense solver only)
    # Resume the adapted rho of the warm-start carry in the structured
    # solver (ops/ltv_qp.py).  The fused solve (ops/admm_cuda.py) always
    # resumes it, as the fused TPU kernel does.
    carry_rho: bool = False
    polish_iters: int = 10
    polish_boost: float = 100.0
    # Escalation pass (mpc.escalate_rejects): re-solve this many of the
    # worst rejected lanes per step with escalate_rho_updates more rounds.
    # Opt-in: on cost-flat kappa weights converged solves drive worse.
    escalate_lanes: int = 0
    escalate_rho_updates: int = 6
    # Stage-system solver of kernels K1 and K3 (ops/admm_cuda.py) and their
    # plain versions: "cr" = block cyclic reduction (ops/cyclic_reduction.py,
    # log2 depth per solve), any other value ("auto", "schur") = the Schur
    # recursion, as in the JAX package's kernels.  Both solve the same SPD
    # stage system; the structured solver ops/ltv_qp.solve_ltv_qp, like the
    # JAX package's XLA solver, always takes the Schur recursion.
    stage_solver: str = "auto"
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """LTV-MPC controller settings (reference: MPC.py:14-59, simulation.py:100-112).

    ``Q``/``R``/``QN`` are the diagonals of the cost matrices.
    """

    N: int = 30
    Q: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    R: Tuple[float, float] = (0.5, 0.0)
    QN: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    v_max: float = 1.0  # m/s
    delta_max: float = 0.66  # rad
    ay_max: float = 4.0  # m/s^2
    v_min: float = 0.0
    xmin: Tuple[float, float, float] = (-math.inf, -math.inf, -math.inf)
    xmax: Tuple[float, float, float] = (math.inf, math.inf, math.inf)
    # accept finite solutions whose primal residual is below this
    feas_tol: float = 5e-3
    # accept least-violation solutions of certified-infeasible QPs
    least_violation_accept: bool = False
    n_scan_samples: int = 128
    max_segments: int = 8
    solver: SolverConfig = SolverConfig()

    def __post_init__(self):
        # Budget-as-regularizer contract: on cost-flat curvature weights
        # (R_kappa == 0) the production iteration budget is the implicit
        # kappa regularizer; converging those QPs drives measurably worse.
        budget = self.solver.iterations * self.solver.rho_updates
        _PRODUCTION_BUDGET = 30 * 6
        if self.R[1] == 0.0 and (budget > 2 * _PRODUCTION_BUDGET
                                 or self.solver.escalate_lanes > 0):
            warnings.warn(
                "High-accuracy solver budget "
                f"({self.solver.iterations}x{self.solver.rho_updates} "
                "iterations"
                + (", escalation on" if self.solver.escalate_lanes else "")
                + ") with a cost-flat curvature weight R[1] == 0: converged "
                "solutions are non-unique in kappa and measured to DRIVE "
                "WORSE than budget-limited ones (the iteration budget is "
                "the implicit regularizer, like OSQP's default eps~1e-3 for "
                "the reference weights). Use R[1] > 0 (e.g. 0.01) when "
                "cranking solver accuracy.", stacklevel=2)

    @property
    def nx(self) -> int:
        return 3

    @property
    def nu(self) -> int:
        return 2

    def kappa_max(self, wheelbase: float) -> float:
        # |kappa| <= tan(delta_max)/L (reference: simulation.py:108-109)
        return math.tan(self.delta_max) / wheelbase


@dataclasses.dataclass(frozen=True)
class SpeedProfileConstraints:
    """Constraints for the curvature-limited speed profile QP
    (reference: simulation.py:115-119, reference_path.py:289-354)."""

    a_min: float = -0.1  # m/s^2
    a_max: float = 0.5  # m/s^2
    v_min: float = 0.0  # m/s
    v_max: float = 1.0  # m/s
    ay_max: float = 4.0  # m/s^2


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Closed-loop simulation settings (reference: simulation.py:121-163)."""

    max_steps: int = 2000
    # Static grid: free segments are extracted once per rollout; False
    # re-extracts them from the grid every step (the semantics a changing
    # grid needs).
    static_grid: bool = True


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Lidar sensor model (reference: lidar_model.py:10-35).

    ``n_ray_samples`` is a fidelity knob: ``conservative=True`` scans are
    cell-exact (reference corner-span semantics) only when the sample
    spacing ``range / (n_ray_samples - 1)`` is below the grid resolution.
    Check with :meth:`validate_for_grid`, or build with :meth:`for_grid`,
    which checks at construction.
    """

    FoV: float = 180.0  # degrees
    range: float = 5.0  # m
    resolution: float = 1.0  # degrees / beam
    n_ray_samples: int = 256  # samples along each beam (fixed-length ray march)
    # target occupancy-grid resolution (m/px); when set, sampling adequacy
    # is validated at construction
    grid_resolution: float | None = None

    def __post_init__(self):
        if self.grid_resolution is not None:
            self.validate_for_grid(self.grid_resolution)

    @classmethod
    def for_grid(cls, grid, **kwargs) -> "LidarConfig":
        """Construct validated against a concrete ``GridMap`` (raises at
        setup if ``n_ray_samples`` undersamples its resolution)."""
        return cls(grid_resolution=float(grid.resolution), **kwargs)

    @property
    def n_beams(self) -> int:
        return int(self.FoV / self.resolution + 1)

    def validate_for_grid(self, grid_resolution: float) -> None:
        """Raise if conservative-mode exactness would quietly degrade on a
        grid of the given resolution (m/px)."""
        spacing = self.range / max(self.n_ray_samples - 1, 1)
        if spacing >= grid_resolution:
            raise ValueError(
                f"LidarConfig sample spacing {spacing:.4g} m >= grid "
                f"resolution {grid_resolution:.4g} m/px: conservative-mode "
                f"scans can skip intersected cells; need n_ray_samples > "
                f"{int(self.range / grid_resolution) + 1}")


def time_optimal_config(cfg: MPCConfig, t_weight: float = 100.0,
                        r_v: float = 0.001,
                        r_kappa: float = 0.001) -> MPCConfig:
    """Time-optimal driving weights: zero running state cost, terminal
    weight on t, near-zero input costs (``r_kappa`` pins the otherwise
    cost-flat curvature input)."""
    return dataclasses.replace(
        cfg, Q=(0.0, 0.0, 0.0), QN=(0.0, 0.0, t_weight), R=(r_v, r_kappa))


# ---------------------------------------------------------------------------
# Scenario presets (parity targets)
# ---------------------------------------------------------------------------

_SIM_TRACK_WP_X = (-0.75, -0.25, -0.25, 0.25, 0.25, 1.25, 1.25, 0.75, 0.75,
                   1.25, 1.25, -0.75, -0.75, -0.25)
_SIM_TRACK_WP_Y = (-1.5, -1.5, -0.5, -0.5, -1.5, -1.5, -1.0, -1.0, -0.5, -0.5,
                   0.0, 0.0, -1.5, -1.5)

# (cx, cy, radius) — reference: simulation.py:40-48
SIM_TRACK_OBSTACLES = (
    (0.0, 0.0, 0.05),
    (-0.8, -0.5, 0.08),
    (-0.7, -1.5, 0.05),
    (-0.3, -1.0, 0.08),
    (0.27, -1.0, 0.05),
    (0.78, -1.47, 0.05),
    (0.73, -0.9, 0.07),
    (1.2, 0.0, 0.08),
    (0.67, -0.05, 0.06),
)


def sim_track_preset(asset_dir: str = "assets/maps", use_obstacles: bool = True):
    """The ``Sim_Track`` scenario (reference: simulation.py:17-54, 100-119)."""
    map_cfg = MapConfig(
        file_path=f"{asset_dir}/sim_map.png",
        origin=(-1.0, -2.0),
        resolution=0.005,
    )
    path_cfg = PathConfig(
        wp_x=_SIM_TRACK_WP_X,
        wp_y=_SIM_TRACK_WP_Y,
        resolution=0.05,
        smoothing_distance=5,
        max_width=0.23,
        circular=True,
    )
    model_cfg = ModelConfig(length=0.12, width=0.06, Ts=0.05)
    mpc_cfg = MPCConfig()
    speed_cfg = SpeedProfileConstraints()
    obstacles = SIM_TRACK_OBSTACLES if use_obstacles else ()
    return map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles


def real_track_preset(asset_dir: str = "assets/maps"):
    """The ``Real_Track`` scenario (reference: simulation.py:58-88)."""
    map_cfg = MapConfig(
        file_path=f"{asset_dir}/real_map.png",
        origin=(-30.0, -24.0),
        resolution=0.06,
    )
    path_cfg = PathConfig(
        wp_x=(-9.169, 11.9, 7.3, -6.95),
        wp_y=(-15.678, 10.9, 14.5, -3.31),
        resolution=0.20,
        smoothing_distance=5,
        max_width=1.50,
        circular=False,
    )
    model_cfg = ModelConfig(length=0.30, width=0.20, Ts=0.05)
    mpc_cfg = MPCConfig()
    speed_cfg = SpeedProfileConstraints()
    return map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, ()
