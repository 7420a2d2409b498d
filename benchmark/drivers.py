"""The one general generator: a traffic file under ``benchmark/traffic/``
names its kind and the kind's parameters; the kind
(``benchmark/kinds/<kind>.py``, found by that name) turns them, the
configuration and the seed into the calls the window makes, and holds
the window's last call to the plain reference (:mod:`benchmark.checks`).
A traffic mix of a kind that is there is a new data file alone; a new
kind is a new module beside the others."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one stream of a run's draws (any whole seed)."""
    return np.random.default_rng([seed % (1 << 64), stream])


@dataclasses.dataclass
class Window:
    seconds: float
    calls: int
    work: int  # lane-steps (fleets) or cycles (api_loop)
    accepted: int
    active: int
    solver_fail: int  # rejected with floor <= 0
    cycle_s: list  # api_loop: every cycle's seconds
    get_control_s: list


def log_counts(log) -> torch.Tensor:
    """(accepted, active, rejected with floor <= 0) lane-steps of a log."""
    act = log.active
    rej = act & ~log.ok
    return torch.stack([(log.ok & act).sum(), act.sum(),
                        (rej & (log.floor <= 0)).sum()])


def kind(name: str):
    """The module ``benchmark/kinds/<name>.py``."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def make(sc, traffic: dict, seed: int, device="cuda"):
    """The driver of a traffic mix, set up from the seed."""
    return kind(traffic["kind"]).Driver(sc, traffic, seed, device)
