"""The port held to the float64 oracle in the JAX package's other oracle-held
task modes: the production budget (tests/test_parity_production.py), the
task-mode laps of tests/test_modes.py and the ``cr`` stage solver against
the oracle; every fixture is what the oracle computes now.  The per-step
scenarios, time-optimal driving (tests/test_parity_topt.py) and
Real_Track's non-circular seam (tests/test_parity_real.py), are held in
tests/test_torch_oracle_topt.py and tests/test_torch_oracle_seam.py
(``tests/oracle_held.py``), a file each.

Each oracle run is a fixture, ``tests/data/torch_oracle_{scenario}.npz``,
written by ``tools/oracle_lap.py --scenario {scenario}`` from the port's
own grid and path; the hash of the oracle's inputs pins it to the scenario
rebuilt here.  The production free run and the mode laps run
``simulate_closed_loop`` laps of 300-400 steps, minutes on the CPU: they
are ``slow`` here and held on the card by ``chip_smoke.py`` phase 20.
Imports no JAX.
"""

import numpy as np
import pytest

from oracle_held import fixture_matches_test
from oracle_held import scenario as _scenario
from tools import oracle_lap as ol

NEW = ("time_optimal", "real_seam", "production")

test_oracle_fixture_matches_scenario = fixture_matches_test(["production"])


@pytest.mark.slow
@pytest.mark.parametrize("name", NEW)
def test_oracle_mode_fixture_is_the_oracle(name):
    """The fixture is what the oracle computes now (seconds to minutes)."""
    sc, lap = _scenario(name)
    fresh = ol.run_oracle(sc)
    for key, val in fresh.items():
        np.testing.assert_allclose(np.asarray(val, np.float64),
                                   np.asarray(lap[key], np.float64),
                                   rtol=0, atol=1e-9, err_msg=key)


@pytest.mark.slow
def test_production_budget_tracks_oracle():
    """tests/test_parity_production.py's bars on the port's free run at the
    production budget (300 steps of ``simulate_closed_loop``, minutes on
    the CPU): the lap done, its length within 15 % of the oracle's, accept
    >= 0.95, pose within 0.10 m of the oracle's over 10 steps and 0.25 m
    over 40."""
    from multi_purpose_mpc_tpu_torch.config import SimConfig
    from multi_purpose_mpc_tpu_torch.simulation import simulate_closed_loop

    sc, lap = _scenario("production")
    res = simulate_closed_loop(sc["grid"], sc["path"], sc["cfg"], sc["model"],
                               SimConfig(max_steps=sc["T"]))
    fr = ol.free_run(res, lap)
    print(f"\n[production] {fr}")
    assert not ol.free_run_misses(fr), fr


@pytest.fixture(scope="module")
def modes():
    """tests/test_modes.py's tracking and time-optimal laps (T = 400)."""
    m = ol.mode_laps(ol.mode_scenario())
    print(f"\n[modes] {m}")
    return m


@pytest.mark.slow
def test_time_optimal_beats_tracking_lap_time(modes):
    tr, to = modes["tracking"], modes["time_optimal"]
    assert tr["done"] and to["done"]
    assert to["lap"] <= tr["lap"], (to["lap"], tr["lap"])


@pytest.mark.slow
def test_time_optimal_mean_speed(modes):
    # time-optimal runs at (or very near) the speed cap wherever allowed
    assert modes["time_optimal"]["v_mean"] > ol.MODE_V_MIN


@pytest.mark.slow
def test_time_optimal_stays_inside_corridor(modes):
    to = modes["time_optimal"]
    assert to["max_ey"] < modes["ey_bar"]
    assert not to["failed"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["convex", "time_optimal"])
def test_cr_against_the_oracle(name):
    """The ``cr`` stage solver's plain version (kernel K1-CR's twin) on every
    pre-step state, at the scenario's bars (the convex exception step's
    speed command printed, not held, as for Schur)."""
    sc, lap = _scenario(name)
    par = ol.parity(ol.port_step(sc, lap, stage_solver="cr"), lap, name)
    print(f"\n[cr oracle] {name}: {ol.describe(par)}")
    assert not ol.misses(par, name), ol.describe(par)
