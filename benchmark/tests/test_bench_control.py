"""The comparison that decides ``correct`` fails its control and the
timed path's faults, and passes the program: each cell on the CPU at a
small size, the program's plain versions in place of its kernels.

The control is the reference put in the program's place at bfloat16
working precision (``checks.check(..., low=True)``); the faults are
planted in the port underneath the driver: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced (the speed command of a fleet, the steering of the single car,
whose speed sits at its cap on the whole of Real_Track), (fleets) every
solve accepted or none (the acceptance test's tolerance made infinite
either way; the single car's solves are all accepted, the control's too,
so its acceptance separates nothing and is not compared), and (LiDAR) a
scan whose hits are lost."""

import dataclasses

import pytest
import torch

from benchmark.tests import cpu_cells as cc
from multi_purpose_mpc_tpu_torch import api, mpc, simulation

FLEETS = ["sim_track.static_fleet", "sim_track.lidar_discovery"]
CELLS = FLEETS + ["real_track.api_loop"]


@pytest.fixture(scope="module")
def sound():
    return {cell: cc.drive(cell) for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(sound, cell):
    found, ok = cc.check(*sound[cell])
    assert ok, found


def test_dynamic_grid_fleet_is_correct():
    """The fleet kind with ``static_grid`` false: K4 and the free runs on
    the grid every step, held to the same reference."""
    found, ok = cc.check(*cc.drive("sim_track.static_fleet",
                                   static_grid=False))
    assert ok, found


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(sound, cell):
    found, ok = cc.check(*sound[cell], low=True)
    assert not ok, found


def still(old):
    return lambda state, *a, **k: state


def half(old):
    def drive(state, path, v, delta, length, Ts):
        new = old(state, path, v, delta, length, Ts)
        keep = torch.arange(state.x.shape[0]) < state.x.shape[0] // 2
        pick = lambda a, b: torch.where(keep, a, b)
        return dataclasses.replace(new, x=pick(new.x, state.x),
                                   y=pick(new.y, state.y),
                                   psi=pick(new.psi, state.psi),
                                   s=pick(new.s, state.s))
    return drive


def altered(old):
    def post(*a, **k):
        out = old(*a, **k)
        return out._replace(v=out.v + 0.02)
    return post


def steered(old):
    def step(*a, **k):
        out = old(*a, **k)
        return out._replace(delta=out.delta + 0.02)
    return step


def tolerance(feas_tol):
    def fault(old):
        def post(state, sol, aux, cfg, model):
            return old(state, sol, aux,
                       dataclasses.replace(cfg, feas_tol=feas_tol), model)
        return post
    return fault


def blind(old):
    def scan(*a, **k):
        out = old(*a, **k)
        return out._replace(hit=torch.zeros_like(out.hit))
    return scan


FAULTS = [(cell, name, obj, attr, fn) for cell in FLEETS for name, obj, attr, fn in (
    ("state unchanged", simulation, "drive", still),
    ("half the batch left out", simulation, "drive", half),
    ("answer altered", mpc, "mpc_post_solve", altered),
    ("every solve accepted", mpc, "mpc_post_solve", tolerance(float("inf"))),
    ("no solve accepted", mpc, "mpc_post_solve", tolerance(-float("inf"))))] + [
    ("sim_track.lidar_discovery", "hits lost", simulation, "scan_fleet", blind),
    ("real_track.api_loop", "state unchanged", api.bike, "drive", still),
    ("real_track.api_loop", "answer altered", api, "mpc_step", steered)]


@pytest.mark.parametrize("cell,name,obj,attr,fn", FAULTS,
                         ids=[f"{c}:{n}" for c, n, *_ in FAULTS])
def test_fault_is_not_correct(cell, name, obj, attr, fn):
    with cc.patched(obj, attr, fn):
        run = cc.drive(cell)
    found, ok = cc.check(*run)
    assert not ok, (name, found)
