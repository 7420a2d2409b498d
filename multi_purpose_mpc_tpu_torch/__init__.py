"""multi_purpose_mpc_tpu_torch — the PyTorch + CUDA port of multi_purpose_mpc_tpu.

A batched closed-loop LTV-MPC for fleets of kinematic-bicycle cars
(reference-path tracking, time-optimal driving and obstacle avoidance by
weight tuning), running on an NVIDIA H100.  The JAX package beside it is
the reference this port is held against; this package imports torch,
numpy, scipy and PIL, never jax.

Ported so far: the static-grid fleet main path, the dynamic-grid fleet
(``SimConfig(static_grid=False)``), per-lane weight sweeps (``WeightSet``),
the escalation pass, LiDAR in the loop (``simulate_lidar_fleet``,
``simulate_lidar_loop``) and the reference-mirroring object API (``Map``,
``ReferencePath``, ``BicycleModel``, ``MPC``, ``LidarModel``: the two-call
loop ``u = mpc.get_control(); car.drive(u)``), fleets sharded over
``torch.distributed`` ranks (``simulate_fleet_sharded``,
``simulate_lidar_fleet_sharded``, ``fleet_metrics``), checkpoint / resume
and the profiling helpers.  Entry points run on the card unless the
caller names another device.

    config.py          typed configs + scenario presets (copied, not imported)
    utils/maps.py      map loading, obstacle rasterization
    utils/kernels.py   nvcc build + ctypes loading of csrc/*.cu
    ops/               grid, rays, path, dense ADMM, speed profile,
                       corridor segments, horizon table, structured ADMM,
                       lidar.py (scans, cell tables, map write-back);
                       corridor_cuda.py (kernel K2), admm_cuda.py (kernels
                       K1 and K3), corridor_extract.py (kernel K4),
                       mapping.py (kernels K5 and K6: fused map write-back
                       + extraction, float32 and bit-packed)
    models/bicycle.py  CarState, frame transforms, plant, linearization
    mpc.py             the fleet control step, the single-lane mpc_step
    simulation.py      closed-loop rollouts (fleet and single car, LiDAR)
    parallel/          the fleet mesh over torch.distributed ranks
                       (mesh.py) and the sharded rollouts (fleet.py)
    utils/checkpoint.py  fleet checkpoint / resume (.npz, torch.save)
    utils/profiling.py   fence, trace, timeit, scan_marginal_cost
    utils/tree.py      flat views of nested state (jax.tree's order)
    api.py             reference-mirroring object API
    utils/viz.py       post-hoc matplotlib rendering
    interop.py         state carried across from the JAX package
"""

from multi_purpose_mpc_tpu_torch.config import (
    LidarConfig,
    MapConfig,
    ModelConfig,
    MPCConfig,
    PathConfig,
    SimConfig,
    SolverConfig,
    SpeedProfileConstraints,
    real_track_preset,
    sim_track_preset,
    time_optimal_config,
)
from multi_purpose_mpc_tpu_torch.ops.grid import (GridMap, add_boundary,
                                                 add_obstacles, m2w, w2m)
from multi_purpose_mpc_tpu_torch.ops.path import PathData, build_reference_path
from multi_purpose_mpc_tpu_torch.models.bicycle import CarState, init_car_state
from multi_purpose_mpc_tpu_torch.mpc import WeightSet, weights_from_config
from multi_purpose_mpc_tpu_torch.api import (MPC, BicycleModel, LidarModel,
                                             Map, Obstacle, ReferencePath)
from multi_purpose_mpc_tpu_torch.parallel.fleet import (
    gather_fleet, simulate_fleet_sharded, simulate_lidar_fleet_sharded)
from multi_purpose_mpc_tpu_torch.parallel.mesh import (
    FleetMesh, fleet_mesh, fleet_metrics, global_fleet_mesh, init_distributed,
    local_lane_slice, round_up_batch)
from multi_purpose_mpc_tpu_torch.utils.checkpoint import (load_fleet_state,
                                                          save_fleet_state)

__version__ = "0.1.0"

__all__ = [
    "BicycleModel",
    "CarState",
    "FleetMesh",
    "GridMap",
    "LidarModel",
    "Map",
    "MPC",
    "Obstacle",
    "PathData",
    "ReferencePath",
    "add_boundary",
    "add_obstacles",
    "build_reference_path",
    "fleet_mesh",
    "fleet_metrics",
    "gather_fleet",
    "global_fleet_mesh",
    "init_distributed",
    "load_fleet_state",
    "local_lane_slice",
    "round_up_batch",
    "save_fleet_state",
    "simulate_fleet_sharded",
    "simulate_lidar_fleet_sharded",
    "init_car_state",
    "m2w",
    "w2m",
    "LidarConfig",
    "MapConfig",
    "ModelConfig",
    "MPCConfig",
    "PathConfig",
    "SimConfig",
    "SolverConfig",
    "SpeedProfileConstraints",
    "WeightSet",
    "real_track_preset",
    "sim_track_preset",
    "time_optimal_config",
    "weights_from_config",
]
