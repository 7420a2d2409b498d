"""The port held to the float64 oracle in time-optimal driving
(tests/test_parity_topt.py's scenario and bars): the fixture
``tests/data/torch_oracle_time_optimal.npz`` and one fleet step from each
of its 160 pre-step states, K2's and K1's plain versions
(``tests/oracle_held.py``).  Imports no JAX."""

from oracle_held import held_tests

(pars, test_oracle_fixture_matches_scenario, test_oracle_mode_acceptance,
 test_oracle_mode_trajectory_1e3, test_oracle_mode_angles) = held_tests(
    "time_optimal")
