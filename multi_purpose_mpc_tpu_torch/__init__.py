"""multi_purpose_mpc_tpu_torch — the PyTorch + CUDA port of multi_purpose_mpc_tpu.

A batched closed-loop LTV-MPC for fleets of kinematic-bicycle cars
(reference-path tracking, time-optimal driving and obstacle avoidance by
weight tuning), running on an NVIDIA H100.  The JAX package beside it is
the reference this port is held against; this package imports torch,
numpy, scipy and PIL, never jax.

Ported so far: the static-grid fleet main path.

    config.py          typed configs + scenario presets (copied, not imported)
    utils/maps.py      map loading, obstacle rasterization
    utils/kernels.py   nvcc build + ctypes loading of csrc/*.cu
    ops/               grid, rays, path, dense ADMM, speed profile,
                       corridor segments, horizon table, structured ADMM;
                       corridor_cuda.py (kernel K2), admm_cuda.py (kernel K1)
    models/bicycle.py  CarState, frame transforms, plant, linearization
    mpc.py             the fleet control step
    simulation.py      closed-loop rollouts (fleet and single car)
    interop.py         state carried across from the JAX package
"""

from multi_purpose_mpc_tpu_torch.config import (
    MapConfig,
    ModelConfig,
    MPCConfig,
    PathConfig,
    SimConfig,
    SolverConfig,
    SpeedProfileConstraints,
    real_track_preset,
    sim_track_preset,
)

__version__ = "0.1.0"

__all__ = [
    "MapConfig",
    "ModelConfig",
    "MPCConfig",
    "PathConfig",
    "SimConfig",
    "SolverConfig",
    "SpeedProfileConstraints",
    "real_track_preset",
    "sim_track_preset",
]
