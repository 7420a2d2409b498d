"""The per-step oracle tests of one held task mode, for the test files that
hold it (``tests/test_torch_oracle_topt.py``: time-optimal driving,
tests/test_parity_topt.py; ``tests/test_torch_oracle_seam.py``:
Real_Track's non-circular seam, tests/test_parity_real.py) and the
fixture check that ``tests/test_torch_oracle_modes.py`` makes for the
production run.

Each oracle run is a fixture, ``tests/data/torch_oracle_{scenario}.npz``,
written by ``tools/oracle_lap.py --scenario {scenario}`` from the port's
own grid and path; the hash of the oracle's inputs pins it to the scenario
rebuilt here.  A held scenario drives one ``simulate_fleet`` step (horizon
table, K2's and K1's plain versions, accept/replay, plant) from every
pre-step state the oracle visits, one lane each from ``init_fleet``'s
fresh solver carry, and holds it to the JAX test's bars verbatim
(``tools/oracle_lap.BARS``):

* time-optimal (tests/test_parity_topt.py:95-141): acceptance equal on
  every step and > 90 % both accept; v, x', y', s' within 1e-3 on every
  step both accept; delta median / p90 / max 2e-2 / 1e-1 / 5e-1, psi'
  1e-2 / 5e-2 / 2.5e-1 (the terminal time weight dilates the QP's cost
  resolution, so no tight subset);
* the seam (tests/test_parity_real.py:95-113): the window >= 200 steps and
  ending at the path end; the bars of tests/test_parity.py.

One scenario a file: the fleet step of each is most of its file's time,
and the test runner spreads files, not tests, over its workers.  Imports
no JAX.
"""

import functools

import pytest

from tools import oracle_lap as ol


@functools.lru_cache(maxsize=None)
def scenario(name):
    """The scenario rebuilt on the CPU and its fixture, hash checked."""
    sc = ol.scenario(name)
    return sc, ol.load_fixture(sc)


def fixture_matches_test(names):
    """``test_oracle_fixture_matches_scenario`` over ``names``."""

    @pytest.mark.parametrize("name", names)
    def test_oracle_fixture_matches_scenario(name):
        """Each fixture's hash is the hash of the oracle's inputs rebuilt
        now, and its window is the JAX test's (>= 100 time-optimal steps;
        >= 200 seam steps ending at the path end)."""
        sc, lap = scenario(name)
        ol.check_window(sc, lap)
        assert len(lap["pre_x"]) == len(lap["x"])

    return test_oracle_fixture_matches_scenario


def held_tests(name):
    """``(pars, test_oracle_fixture_matches_scenario,
    test_oracle_mode_acceptance, test_oracle_mode_trajectory_1e3,
    test_oracle_mode_angles)`` of the held scenario ``name``: the module
    fixture ``pars`` (the port's step from every pre-step state) and the
    tests, each parametrised over ``[name]``."""

    @pytest.fixture(scope="module")
    def pars():
        sc, lap = scenario(name)
        # one torch thread: alone the step takes as long on one thread as
        # on eight (~15 s, the same results); on eight, beside the test
        # runner's five other workers, the seam's took 748 s
        with ol.one_thread():
            port = ol.port_step(sc, lap)
        return {name: ol.parity(port, lap, name)}

    @pytest.mark.parametrize("name", [name])
    def test_oracle_mode_acceptance(pars, name):
        # acceptance agreement on every step, an overwhelmingly accepted
        # run and (seam) >= 80 % of it tight
        par, bars = pars[name], ol.BARS[name]
        assert par["disagree"].size == 0, \
            f"acceptance disagrees at steps {par['disagree']}"
        assert par["both"] > bars.both_min
        if bars.tight_rprim is not None:
            assert par["tight"] >= bars.tight_min * par["steps"], \
                f"only {par['tight']}/{par['steps']} well-posed steps"

    @pytest.mark.parametrize("coord", ["x", "y", "s", "v"])
    @pytest.mark.parametrize("name", [name])
    def test_oracle_mode_trajectory_1e3(pars, name, coord):
        # next pose, progress and the speed command within 1e-3 on every
        # step both accept
        par = pars[name]
        assert par[f"{coord}_max"] <= ol.BARS[name].traj, \
            (f"{coord}: max |diff| {par[f'{coord}_max']:.3e} at step "
             f"{par[f'{coord}_argmax']}")

    @pytest.mark.parametrize("angle", ["delta", "psi"])
    @pytest.mark.parametrize("name", [name])
    def test_oracle_mode_angles(pars, name, angle):
        # steering and heading to the QP's cost resolution: the JAX test's
        # median / p90 / tight / all-step bars
        par = pars[name]
        held = [m for m in ol.misses(par, name) if m.startswith(angle + " ")]
        assert not held, (held, par)

    return (pars, fixture_matches_test([name]), test_oracle_mode_acceptance,
            test_oracle_mode_trajectory_1e3, test_oracle_mode_angles)
