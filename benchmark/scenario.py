"""The program's objects of one configuration, built from its file under
``benchmark/configs/``: the port's config dataclasses, the grid and the
reference path on the card."""

from __future__ import annotations

import dataclasses
import os

import torch

from multi_purpose_mpc_tpu_torch.config import (LidarConfig, MapConfig,
                                                ModelConfig, MPCConfig,
                                                PathConfig, SolverConfig,
                                                SpeedProfileConstraints)


@dataclasses.dataclass
class Scenario:
    cfg: dict
    map_cfg: MapConfig
    path_cfg: PathConfig
    model: ModelConfig
    mpc: MPCConfig
    speed: SpeedProfileConstraints
    lidar: LidarConfig
    obstacles: tuple


def configs(cfg: dict, root: str) -> Scenario:
    """The port's configuration objects of a configuration file."""
    m, p, mpc = cfg["map"], cfg["path"], dict(cfg["mpc"])
    mpc["solver"] = SolverConfig(**mpc["solver"])
    for key in ("Q", "R", "QN"):
        mpc[key] = tuple(mpc[key])
    map_cfg = MapConfig(file_path=os.path.join(root, m["file"]),
                        origin=tuple(m["origin"]), resolution=m["resolution"],
                        threshold_occupied=m["threshold_occupied"],
                        hole_area_threshold=m["hole_area_threshold"])
    path_cfg = PathConfig(**{**p, "wp_x": tuple(p["wp_x"]),
                             "wp_y": tuple(p["wp_y"])})
    return Scenario(cfg=cfg, map_cfg=map_cfg, path_cfg=path_cfg,
                    model=ModelConfig(**cfg["model"]), mpc=MPCConfig(**mpc),
                    speed=SpeedProfileConstraints(**cfg["speed"]),
                    lidar=LidarConfig(**cfg["lidar"]),
                    obstacles=tuple(tuple(o) for o in cfg["obstacles"]))


def world(sc: Scenario, device="cuda"):
    """``(grid, path)``: the map with its obstacles and the reference path
    with its speed profile, as the port's fleet entries take them (the
    path's static borders are found before the obstacles are added)."""
    from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path
    from multi_purpose_mpc_tpu_torch.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu_torch.utils.maps import (add_obstacles_host,
                                                        load_grid_map)

    grid = load_grid_map(sc.map_cfg, device=device)
    centre = build_reference_path(grid, sc.path_cfg)
    if sc.obstacles:
        grid = add_obstacles_host(grid, sc.map_cfg.origin,
                                  sc.map_cfg.resolution, sc.obstacles)
    return grid, compute_speed_profile(centre, sc.speed)


def free_like(grid):
    """An all-free map of ``grid``'s geometry (a LiDAR fleet's known map
    before its first scan)."""
    return dataclasses.replace(grid, occ=torch.ones_like(grid.occ))
