"""Port parity at horizon N = 60, twice the reference's N = 30: the solvers
and a rollout of the port on the CPU against the JAX package, with the
bars tests/test_horizon.py holds the JAX package's own N = 60 kernel to.

Kernels K1 and K3 take any N up to ``admm_cuda.N_MAX`` (bounded by shared
memory); on the CPU the wrappers run their plain versions, which these
tests hold against the JAX package.  The kernels themselves are held
bitwise against the plain versions at N = 1 ... 60 in
tests/test_torch_cuda.py, on the card.
"""

import dataclasses

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
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import SimConfig, SolverConfig
from multi_purpose_mpc_tpu_torch.ops import admm_cuda
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from multi_purpose_mpc_tpu_torch.ops.horizon_table import build_horizon_table
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import LTVQP, solve_ltv_qp
from tests.test_ltv_qp import _random_qp
from tests.test_torch_setup import jax_scenario, port_configs

N = 60


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    s["mpc_cfg"] = dataclasses.replace(s["mpc_cfg"], N=N)
    model_cfg, mpc_cfg = port_configs(N=N)
    s.update(tpath=interop.path_data(s["path"]), tmodel=model_cfg,
             tcfg=mpc_cfg, tgrid=interop.grid_map(s["grid"]),
             tsegs=interop.segment_candidates(s["segs"]))
    return s


def _to_port_qp(jqp) -> LTVQP:
    return LTVQP(**{k: torch.tensor(np.asarray(getattr(jqp, k)))
                    for k in LTVQP.__dataclass_fields__})


@pytest.mark.parametrize("solver", ["solve_ltv_qp", "solve_ltv_qp_structured"])
def test_structured_solvers_match_jax_at_n60(solver):
    """The port's plain structured solvers against the JAX XLA solver on
    random N = 60 QPs, at tests/test_horizon.py's reduced budget and bars
    (status equal, r_prim 1e-3, U[..., 0] 2e-3, X 5e-3).  From the fresh
    carry both resume cfg.rho, so K3's entry (the TPU entry's semantics)
    and the XLA-style solver see the same problem."""
    cfg = dict(iterations=10, rho_updates=1, polish_iters=0)
    rng = np.random.default_rng(5)
    B = 2
    batched = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[_random_qp(rng, N=N) for _ in range(B)])
    warm = jax.vmap(lambda _: jinit_carry(N))(jnp.arange(B))
    ref = jax.vmap(lambda q, w: jsolve(q, JSolverConfig(**cfg), warm=w))(
        batched, warm)
    fn = (solve_ltv_qp if solver == "solve_ltv_qp"
          else admm_cuda.solve_ltv_qp_structured)
    out = fn(_to_port_qp(batched), cfg=SolverConfig(**cfg),
             warm=interop.solver_carry(warm))
    assert out.X.shape == (B, N + 1, 3)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-3)
    np.testing.assert_allclose(out.U[..., 0].numpy(),
                               np.asarray(ref.U[..., 0]), atol=2e-3)
    np.testing.assert_allclose(out.X.numpy(), np.asarray(ref.X), atol=5e-3)


def test_k1_twin_matches_xla_pipeline_at_n60(sc):
    """K1's plain twin (the fused solve on the CPU) at N = 60 against the
    JAX package's XLA branch on the same lanes, at the bars of
    tests/test_torch_admm.py::test_k1_twin_matches_xla_pipeline (status
    equal, r_prim 1e-4, U[:, 0, 0] 3e-3, floor 1e-6)."""
    B = 8
    i = np.arange(B)
    e_y, wp = 0.04 * (i - 4), 23 * i  # some lanes outside the corridor
    jp, cfg, mo = sc["path"], sc["mpc_cfg"], sc["model_cfg"]

    @jax.jit
    def pipeline(e_y, wp):
        states = jax.vmap(lambda e, w: jinit(jp, N, e_y=e, wp_id=w))(e_y, wp)
        located = jax.vmap(lambda s: jlocate(s, jp))(states)
        cor = jax.vmap(lambda w: jcorridor(w, jp, sc["grid"], cfg, mo,
                                           sc["segs"]))(located[0])
        qp, aux = jax.vmap(lambda s, loc, c: jpre_solve(
            s, jp, sc["grid"], cfg, mo, sc["segs"], located=loc,
            corridor=c))(states, located, cor)
        ref = jax.vmap(lambda q, w: jsolve(q, cfg.solver, warm=w))(
            qp, states.solver)
        return states, located, cor, aux, ref

    states, located, cor, aux, ref = pipeline(jnp.asarray(e_y, jnp.float32),
                                              jnp.asarray(wp, jnp.int32))
    tp = sc["tpath"]
    st = interop.car_state(states)
    wpt, ey_t, epsi_t = (torch.tensor(np.asarray(a)) for a in located)
    idx = (wpt.long()[:, None] + torch.arange(N)[None, :]) % tp.n_wp
    horizon = (tp.v_ref[idx], tp.kappa[idx], tp.seg_dist[idx])
    corridor = Corridor(*(torch.tensor(np.asarray(a)) for a in cor))
    x0 = torch.stack([ey_t, epsi_t, torch.zeros_like(ey_t)], -1)
    kp = tmpc.kappa_predictions(st.u_seq, N)
    sol, floor = admm_cuda.solve_mpc_qp_fused(
        *horizon, corridor.lb, corridor.ub, x0, kp, st.solver,
        sc["tcfg"].solver, sc["tcfg"], sc["tmodel"])
    assert sol.X.shape == (B, N + 1, 3)
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(sol.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-4)
    np.testing.assert_allclose(sol.U[:, 0, 0].numpy(),
                               np.asarray(ref.U[:, 0, 0]), atol=3e-3)
    np.testing.assert_allclose(floor.numpy(), np.asarray(aux[4]), atol=1e-6)
    assert (floor.numpy() > 0).any(), "no off-corridor lane sampled"


def test_horizon_60_port_rollout(sc):
    """A few steps of the port's static-grid fleet at N = 60 on the CPU
    (K2's and K1's plain versions), from tests/test_horizon.py's starts:
    every lane progresses, none fails, the accept rate and e_y stay in
    that test's bands."""
    T = 4
    fleet0 = tsim.init_fleet(sc["tpath"], N, 3,
                             wp_id0=torch.tensor([0, 70, 140],
                                                 dtype=torch.int32))
    table = build_horizon_table(sc["tpath"], sc["tsegs"], sc["tcfg"])
    res = tsim.simulate_fleet(sc["tgrid"], sc["tpath"], sc["tcfg"],
                              sc["tmodel"], SimConfig(max_steps=T), fleet0,
                              table=table)
    assert res.final_state.solver.X.shape == (3, N + 1, 3)
    ds = (res.final_state.s - fleet0.s).numpy()
    assert (ds > 0.05).all(), ds
    assert not res.final_state.failed.any()
    act = res.log.active
    assert float(res.log.ok[act].float().mean()) > 0.8
    assert float(res.log.e_y.abs().max()) < 0.25


def test_kernel_horizon_bound():
    """The kernels' horizon is bounded by one block's shared memory, at
    least 64 and well past the reference's 30."""
    assert admm_cuda.N_MAX >= 64
    assert admm_cuda.lane_smem_bytes(admm_cuda.N_MAX) <= 232448
    assert admm_cuda.lane_smem_bytes(admm_cuda.N_MAX + 1) > 232448
    assert admm_cuda.lane_smem_bytes(30) % 16 == 0
    with pytest.raises(ValueError, match="shared memory"):
        admm_cuda._check_horizon(admm_cuda.N_MAX + 1)
    with pytest.raises(ValueError):
        admm_cuda._check_horizon(0)
