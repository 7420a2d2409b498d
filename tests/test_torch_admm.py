"""Port parity, solver layer: kernel K1's plain twin
(ops/admm_cuda.solve_mpc_qp_fused, CPU dispatch) and the port's structured
solver (ops/ltv_qp.solve_ltv_qp) against the JAX package on the CPU.

The JAX side runs its XLA branch — assemble_ltv_qp + vmapped solve_ltv_qp
+ the external corridor_violation_floor — which is what the fused TPU
kernel is held against (tests/test_admm_pallas.py:101-211); the bars are
the ones those tests set: status equal, r_prim 1e-4, U[:, 0, 0] 3e-3,
floor 1e-6.

One difference is part of the fused solve, not noise: its status uses the
raw-data bound qmax for eps_d (admm_pallas.py:1255-1268), the XLA solver
scale_d (ltv_qp.py:424-427).  The statuses still agree on these QPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.config import SolverConfig as JSolverConfig
from multi_purpose_mpc_tpu.models.bicycle import init_car_state as jinit
from multi_purpose_mpc_tpu.mpc import (mpc_corridor as jcorridor,
                                       mpc_locate as jlocate,
                                       mpc_pre_solve as jpre_solve)
from multi_purpose_mpc_tpu.ops.ltv_qp import (init_solver_carry as jinit_carry,
                                              solve_ltv_qp as jsolve)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import mpc as tmpc
from multi_purpose_mpc_tpu_torch.config import SolverConfig
from multi_purpose_mpc_tpu_torch.ops import admm as tadmm
from multi_purpose_mpc_tpu_torch.ops.admm_cuda import (
    solve_mpc_qp_fused, solve_mpc_qp_fused_cuda)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import LTVQP, solve_ltv_qp
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from tests.test_ltv_qp import _random_qp
from tests.test_torch_setup import jax_scenario, port_configs

B = 8


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    model_cfg, mpc_cfg = port_configs()
    s.update(tpath=interop.path_data(s["path"]), tmodel=model_cfg,
             tcfg=mpc_cfg)
    return s


def _jax_pipeline(sc, e_y, wp):
    """JAX states, their XLA-branch QPs, solutions and floors (one jitted
    program per module, reused for every lane set of the same size)."""
    if "pipeline" not in sc:
        jp, cfg, mo = sc["path"], sc["mpc_cfg"], sc["model_cfg"]

        def pipeline(e_y, wp):
            states = jax.vmap(lambda e, w: jinit(jp, cfg.N, e_y=e, wp_id=w))(
                e_y, wp)
            located = jax.vmap(lambda s: jlocate(s, jp))(states)
            cor = jax.vmap(lambda w: jcorridor(w, jp, sc["grid"], cfg, mo,
                                               sc["segs"]))(located[0])
            qp, aux = jax.vmap(lambda s, loc, c: jpre_solve(
                s, jp, sc["grid"], cfg, mo, sc["segs"], located=loc,
                corridor=c))(states, located, cor)
            ref = jax.vmap(lambda q, w: jsolve(q, cfg.solver, warm=w))(
                qp, states.solver)
            return states, located, cor, qp, aux, ref

        sc["pipeline"] = jax.jit(pipeline)
    return sc["pipeline"](jnp.asarray(e_y, jnp.float32),
                          jnp.asarray(wp, jnp.int32))


def _port_inputs(sc, states, located, cor):
    """The fused solve's inputs for the same lanes, through the port."""
    tp = sc["tpath"]
    st = interop.car_state(states)
    wp, e_y, e_psi = (torch.tensor(np.asarray(a)) for a in located)
    idx = (wp.long()[:, None] + torch.arange(30)[None, :]) % tp.n_wp
    horizon = (tp.v_ref[idx], tp.kappa[idx], tp.seg_dist[idx])
    corridor = Corridor(*(torch.tensor(np.asarray(a)) for a in cor))
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    kp = tmpc.kappa_predictions(st.u_seq, 30)
    return st, horizon, corridor, x0, kp, e_y, e_psi


@pytest.mark.parametrize("case", ["centred", "off_corridor"])
def test_k1_twin_matches_xla_pipeline(sc, case):
    i = np.arange(B)
    if case == "centred":
        e_y, wp = 0.005 * i, 13 * i
    else:  # large |e_y| pushes lanes outside the margin-shrunk corridor
        e_y, wp = 0.04 * (i - 4), 23 * i
    states, located, cor, _, aux, ref = _jax_pipeline(sc, e_y, wp)
    st, horizon, corridor, x0, kp, _, _ = _port_inputs(sc, states, located, cor)
    sol, floor = solve_mpc_qp_fused(*horizon, corridor.lb, corridor.ub, x0, kp,
                                    st.solver, sc["tcfg"].solver, sc["tcfg"],
                                    sc["tmodel"])
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(sol.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-4)
    np.testing.assert_allclose(sol.U[:, 0, 0].numpy(),
                               np.asarray(ref.U[:, 0, 0]), atol=3e-3)
    np.testing.assert_allclose(floor.numpy(), np.asarray(aux[4]), atol=1e-6)
    if case == "off_corridor":
        assert (floor.numpy() > 0).any(), "no off-corridor lane sampled"
    # the carry's step size is the adapted one the kernel returns
    assert torch.isfinite(sol.carry.rho).all()


def test_assemble_and_floor_match(sc):
    i = np.arange(B)
    states, located, cor, qp, aux, _ = _jax_pipeline(sc, 0.04 * (i - 4), 23 * i)
    st, horizon, corridor, _, kp, e_y, e_psi = _port_inputs(
        sc, states, located, cor)
    tqp = tmpc.assemble_ltv_qp(sc["tcfg"], sc["tmodel"], e_y, e_psi, kp,
                               corridor, horizon)
    for f in ("A", "B", "beq", "q_x", "q_u", "P_x", "P_u", "lx", "ux", "lu",
              "uu"):
        np.testing.assert_allclose(getattr(tqp, f).numpy(),
                                   np.asarray(getattr(qp, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    fl = tmpc.corridor_violation_floor(e_y, e_psi, horizon, corridor,
                                       sc["tcfg"], sc["tmodel"])
    np.testing.assert_allclose(fl.numpy(), np.asarray(aux[4]), atol=1e-6)


def _to_port_qp(jqp) -> LTVQP:
    return LTVQP(**{k: torch.tensor(np.asarray(getattr(jqp, k)))
                    for k in LTVQP.__dataclass_fields__})


def test_structured_solver_matches_jax(sc):
    """The port's solve_ltv_qp vs the JAX one on the same scenario QPs and
    warm carries.  Bars of bench.py:_assert_solver_agreement (compiled TPU
    kernel vs XLA solver): statuses and acceptance identical, and the speed
    command within 2e-2 — on pinch-point lanes the active set is
    near-degenerate and two eps~1e-3 solvers differ by O(1e-3..1e-2) from
    operation order alone; the median lane agrees to 1e-3."""
    i = np.arange(B)
    states, _, _, qp, _, ref = _jax_pipeline(sc, 0.005 * i, 13 * i)
    out = solve_ltv_qp(_to_port_qp(qp), sc["tcfg"].solver,
                       interop.solver_carry(states.solver))
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    feas = sc["tcfg"].feas_tol
    np.testing.assert_array_equal(out.r_prim.numpy() <= feas,
                                  np.asarray(ref.r_prim) <= feas)
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-3)
    d_v0 = np.abs(out.U[:, 0, 0].numpy() - np.asarray(ref.U[:, 0, 0]))
    assert d_v0.max() <= 2e-2 and np.median(d_v0) <= 1e-3, d_v0


def test_structured_solver_random_qps():
    """Random well-posed QPs (tests/test_ltv_qp.py) at a 3-round budget,
    the configuration tests/test_admm_pallas.py uses."""
    rng = np.random.default_rng(11)
    qps = [_random_qp(rng) for _ in range(4)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    warm = jax.vmap(lambda _: jinit_carry(8))(jnp.arange(4))
    jc = JSolverConfig(iterations=30, rho_updates=3)
    ref = jax.vmap(lambda q, w: jsolve(q, jc, warm=w))(batched, warm)
    out = solve_ltv_qp(_to_port_qp(batched),
                       SolverConfig(iterations=30, rho_updates=3),
                       interop.solver_carry(warm))
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-3)
    np.testing.assert_allclose(out.U[..., 0].numpy(),
                               np.asarray(ref.U[..., 0]), atol=2e-3)


def test_k1_nan_lane_diverges_and_resets(sc):
    """A NaN input flags only its own lane DIVERGED, and that lane's carry
    resets to the fresh carry so the next solve starts clean."""
    i = np.arange(B)
    states, located, cor, _, _, _ = _jax_pipeline(sc, 0.005 * i, 13 * i)
    st, horizon, corridor, x0, kp, _, _ = _port_inputs(sc, states, located, cor)
    v = horizon[0].clone()
    v[0, 3] = float("nan")
    sol, _ = solve_mpc_qp_fused(v, *horizon[1:], corridor.lb, corridor.ub,
                                x0, kp, st.solver, sc["tcfg"].solver,
                                sc["tcfg"], sc["tmodel"])
    assert int(sol.status[0]) == tadmm.DIVERGED
    assert (sol.status[1:] != tadmm.DIVERGED).all()
    assert torch.isfinite(sol.carry.X[0]).all()
    assert float(sol.carry.rho[0]) == np.float32(sc["tcfg"].solver.rho)


def test_k1_cuda_wrapper_refuses_cpu_tensors(sc):
    i = np.arange(B)
    states, located, cor, _, _, _ = _jax_pipeline(sc, 0.005 * i, 13 * i)
    st, horizon, corridor, x0, kp, _, _ = _port_inputs(sc, states, located, cor)
    with pytest.raises(ValueError):
        solve_mpc_qp_fused_cuda(*horizon, corridor.lb, corridor.ub, x0, kp,
                                st.solver, sc["tcfg"].solver, sc["tcfg"],
                                sc["tmodel"])
