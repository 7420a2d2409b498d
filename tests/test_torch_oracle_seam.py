"""The port held to the float64 oracle on Real_Track's non-circular seam
(tests/test_parity_real.py's scenario and bars): the fixture
``tests/data/torch_oracle_real_seam.npz`` and one fleet step from each of
its 213 pre-step states to the path end, K2's and K1's plain versions
(``tests/oracle_held.py``).  Imports no JAX."""

from oracle_held import held_tests

(pars, test_oracle_fixture_matches_scenario, test_oracle_mode_acceptance,
 test_oracle_mode_trajectory_1e3, test_oracle_mode_angles) = held_tests(
    "real_seam")
