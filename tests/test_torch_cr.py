"""Port parity, the cyclic-reduction stage solver
(``SolverConfig(stage_solver="cr")``): the plain CR solve
(ops/cyclic_reduction.py) against a float64 dense solve and the port's
Schur recursion, and kernels K1 / K3's CR plain versions against the JAX
package's CR kernel (interpret mode on the CPU), the float64 oracle and the
Schur solves, on the CPU.

Tolerances against JAX are those of tests/test_admm_pallas.py's CR tests,
not bitwise: XLA:CPU contracts multiply-adds into FMAs and the port rounds
every product (ROADMAP Queue 3), and the equality rows carry rho x 1e3, so
float noise moves near-converged residuals and the adapted rho.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.config import SolverConfig as JSolverConfig
from multi_purpose_mpc_tpu.ops.admm_pallas import solve_ltv_qp_pallas
from multi_purpose_mpc_tpu.ops.ltv_qp import (init_solver_carry as jinit_carry,
                                              materialize_dense)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch import simulation as tsim
from multi_purpose_mpc_tpu_torch.config import SimConfig, SolverConfig
from multi_purpose_mpc_tpu_torch.mpc import kappa_predictions, mpc_locate
from multi_purpose_mpc_tpu_torch.ops import admm as tadmm
from multi_purpose_mpc_tpu_torch.ops import admm_cuda
from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select
from multi_purpose_mpc_tpu_torch.ops.cyclic_reduction import (cr_factor,
                                                              cr_solve,
                                                              padded_stages)
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    build_horizon_table, gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (LTVQP, StageQP,
                                                    _build_blocks, _factor,
                                                    _solve, admm_rounds,
                                                    pack_carry, pack_qp,
                                                    solve_ltv_qp)
from tests.oracle.qp import optimality_gap, primal_violation, solve_qp_f64
from tests.test_ltv_qp import _random_qp
from tests.test_torch_setup import jax_scenario, port_configs

CFG = SolverConfig(iterations=30, rho_updates=3)
CFG_CR = dataclasses.replace(CFG, stage_solver="cr")


def _to_port_qp(jqp) -> LTVQP:
    return LTVQP(**{k: torch.tensor(np.asarray(getattr(jqp, k)))
                    for k in LTVQP.__dataclass_fields__})


# ---------------------------------------------------------------------------
# (a) the stage solve alone
# ---------------------------------------------------------------------------

def _dense(D, C):
    """The block-tridiagonal stage matrix of (D, C), float64."""
    Bsz, S = D.shape[:2]
    M = np.zeros((Bsz, 5 * S, 5 * S))
    for s in range(S):
        M[:, 5 * s:5 * s + 5, 5 * s:5 * s + 5] = D[:, s]
    for n in range(S - 1):
        M[:, 5 * n + 5:5 * n + 8, 5 * n:5 * n + 5] = C[:, n]
        M[:, 5 * n:5 * n + 5, 5 * n + 5:5 * n + 8] = np.swapaxes(C[:, n], 1, 2)
    return M


def test_padded_stages():
    """The least 2^k - 1 that holds the N + 1 stages (the JAX kernel's
    mfull_cr): N = 30 fits exactly, N = 8 pads 9 to 15, N = 31 pads 32 to
    63, N = 60 pads 61 to 63."""
    assert [padded_stages(n + 1) for n in (1, 2, 8, 30, 31, 60)] == \
        [3, 3, 15, 31, 63, 63]


@pytest.mark.parametrize("N", [1, 2, 8, 30, 31, 60])
def test_cr_stage_solve_matches_dense_and_schur(N):
    """cr_factor + cr_solve on the stage system of ``_build_blocks`` against
    a float64 dense solve and the Schur recursion, B = 4 random stage QPs.
    Relative inf-norm error <= 1e-4 (measured <= 5.5e-7 against the dense
    solve, <= 6.6e-7 against Schur: float32 rounding of a system of
    condition ~1e2; equality rows at 10 rho keep it there)."""
    rng = np.random.default_rng(N)
    B = 4
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    sq = StageQP(AB=t(rng.uniform(-1, 1, (B, N, 3, 5))),
                 beq=t(rng.normal(size=(B, N + 1, 3))),
                 Pd=t(rng.uniform(0.1, 2.0, (B, N + 1, 5))),
                 qv=t(rng.normal(size=(B, N + 1, 5))),
                 lw=t(-np.ones((B, N + 1, 5))), uw=t(np.ones((B, N + 1, 5))))
    rho = t(rng.uniform(0.1, 1.0, B))
    D, C = _build_blocks(sq, 10.0 * rho, rho[:, None, None].expand(B, N + 1, 5),
                         1e-6)
    b = t(rng.normal(size=(B, N + 1, 5)))
    w = cr_solve(cr_factor(D, C), b)
    assert w.shape == b.shape and w.dtype == torch.float32
    x = np.linalg.solve(_dense(D.double().numpy(), C.double().numpy()),
                        b.double().numpy().reshape(B, -1, 1)).reshape(B, -1, 5)
    rel = lambda y, ref: float((np.abs(y - ref).max(axis=(1, 2))
                                / np.abs(ref).max(axis=(1, 2))).max())
    assert rel(w.double().numpy(), x) <= 1e-4
    ws = _solve(_factor(D, C), C, b).double().numpy()
    assert rel(w.double().numpy(), ws) <= 1e-4


# ---------------------------------------------------------------------------
# (b), (c) the structured solve (kernel K3's plain version)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    """tests/test_admm_pallas.py's batch (seed 11, B = 4, N = 8) and the
    JAX CR kernel's solve of it in interpret mode (~30 s, once)."""
    rng = np.random.default_rng(11)
    qps = [_random_qp(rng) for _ in range(4)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    warm = jax.vmap(lambda _: jinit_carry(8))(jnp.arange(4))
    ref = solve_ltv_qp_pallas(
        batched, warm,
        JSolverConfig(iterations=30, rho_updates=3, stage_solver="cr"),
        lanes=8, interpret=True)
    return qps, batched, warm, ref


def test_structured_cr_matches_jax_cr_kernel(batch):
    """Bars of tests/test_admm_pallas.py (CR vs Schur, kernel vs XLA):
    status equal, r_prim within 1e-3, U[..., 0] within 2e-3, the carried
    rho within a factor of 30."""
    _, batched, warm, ref = batch
    out = admm_cuda.solve_ltv_qp_structured(_to_port_qp(batched),
                                            interop.solver_carry(warm), CFG_CR)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-3)
    np.testing.assert_allclose(out.U[..., 0].numpy(),
                               np.asarray(ref.U[..., 0]), atol=2e-3)
    ratio = out.carry.rho.numpy() / np.asarray(ref.carry.rho)
    assert (ratio > 1 / 30).all() and (ratio < 30).all(), ratio


def test_structured_cr_matches_schur(batch):
    """The port's CR against its Schur solve on the same QPs, at the bars
    of tests/test_admm_pallas.py's test_cr_matches_schur_stage_solver."""
    _, batched, warm, _ = batch
    qp, carry = _to_port_qp(batched), interop.solver_carry(warm)
    out = admm_cuda.solve_ltv_qp_structured(qp, carry, CFG_CR)
    ref = admm_cuda.solve_ltv_qp_structured(qp, carry, CFG)
    np.testing.assert_array_equal(out.status.numpy(), ref.status.numpy())
    np.testing.assert_allclose(out.r_prim.numpy(), ref.r_prim.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(out.U[..., 0].numpy(), ref.U[..., 0].numpy(),
                               atol=2e-3)


def test_structured_cr_against_f64_oracle(batch):
    """100 x 8 budget, feasibility and optimality gap per lane against the
    float64 oracle (tests/test_admm_pallas.py's test_cr_against_f64_oracle:
    both < 2e-3, no lane diverged)."""
    qps, batched, warm, _ = batch
    out = admm_cuda.solve_ltv_qp_structured(
        _to_port_qp(batched), interop.solver_carry(warm),
        SolverConfig(iterations=100, rho_updates=8, stage_solver="cr"))
    for i, qp in enumerate(qps):
        P, q, A, l, u = materialize_dense(qp)
        x_ref, _, _ = solve_qp_f64(P, q, A, l, u)
        z = np.concatenate([out.X[i].numpy().reshape(-1),
                            out.U[i].numpy().reshape(-1)])
        assert primal_violation(A, l, u, z) < 2e-3, i
        assert abs(optimality_gap(P, q, z, x_ref)) < 2e-3, i
        assert int(out.status[i]) != tadmm.DIVERGED


def test_auto_is_schur_and_xla_counterpart_ignores_cr(batch):
    """"auto" (the default) is the Schur recursion bit for bit, and the
    port's solve_ltv_qp, like the JAX package's XLA solver, takes the Schur
    recursion whatever stage_solver says."""
    _, batched, warm, _ = batch
    qp, carry = _to_port_qp(batched), interop.solver_carry(warm)
    assert SolverConfig().stage_solver == "auto"
    sq, rho0 = pack_qp(qp), carry.rho
    auto = admm_rounds(sq, CFG, pack_carry(carry), rho0)
    schur = admm_rounds(sq, dataclasses.replace(CFG, stage_solver="schur"),
                        pack_carry(carry), rho0)
    cr = admm_rounds(sq, CFG_CR, pack_carry(carry), rho0)
    for a, b in zip(auto[0] + (auto[1],), schur[0] + (schur[1],)):
        assert torch.equal(a, b)
    assert not torch.equal(auto[0][0], cr[0][0])
    xla = solve_ltv_qp(qp, CFG, carry)
    xla_cr = solve_ltv_qp(qp, CFG_CR, carry)
    assert torch.equal(xla.X, xla_cr.X) and torch.equal(xla.U, xla_cr.U)
    assert torch.equal(xla.carry.rho, xla_cr.carry.rho)


def test_cr_horizon_bound():
    """A CR lane holds 61 floats a stage, 30 a padded stage and 30 an odd
    stage of any level in shared memory (csrc/admm_core.cuh, lane_floats):
    14,416 bytes at N = 30, and N_MAX_CR = 453 is the longest horizon one
    block holds."""
    assert admm_cuda.lane_smem_bytes(30, True) == 14416
    assert admm_cuda.lane_smem_bytes(30) == 14016
    assert admm_cuda.N_MAX_CR == 453 and admm_cuda.N_MAX == 513
    assert admm_cuda.lane_smem_bytes(453, True) <= 232448 \
        < admm_cuda.lane_smem_bytes(454, True)
    admm_cuda._check_horizon(453, True)
    admm_cuda._check_horizon(513, False)
    with pytest.raises(ValueError, match="cyclic reduction kernel's 1..453"):
        admm_cuda._check_horizon(454, True)


# ---------------------------------------------------------------------------
# (d), (e) the fused solve (kernel K1's plain version) and a rollout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    tmodel, tcfg = port_configs()
    tpath = interop.path_data(s["path"])
    return dict(tgrid=interop.grid_map(s["grid"]), tpath=tpath,
                tmodel=tmodel, tcfg=tcfg,
                table=build_horizon_table(
                    tpath, interop.segment_candidates(s["segs"]), tcfg))


def test_fused_cr_matches_fused_schur(sc):
    """K1's plain version with CR against the Schur one on Sim_Track QPs,
    B = 8, N = 30 (31 stages, no pad), the lanes of tests/test_admm_pallas.py's
    test_cr_fused_assembly_scenario and its bars: status equal, r_prim
    within 1e-3, U[:, 0, 0] within 3e-3.  The CPU tensors take the plain
    version, and no kernel launch is counted."""
    cfg, model, tpath = sc["tcfg"], sc["tmodel"], sc["tpath"]
    S, i = cfg.max_segments, np.arange(8)
    fleet = tsim.init_fleet(tpath, cfg.N, 8,
                            e_y0=torch.tensor(0.005 * i, dtype=torch.float32),
                            wp_id0=torch.tensor(13 * i, dtype=torch.int32))
    wp, e_y, e_psi = mpc_locate(fleet, tpath)
    blk = gather_horizon_block(sc["table"], wp)
    cor = corridor_select(blk, S, model.safety_margin)
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    args = (*solver_inputs_from_block(blk, S), cor.lb, cor.ub, x0,
            kappa_predictions(fleet.u_seq, cfg.N), fleet.solver)
    n = (admm_cuda.solve_mpc_qp_fused_cuda.launches,
         admm_cuda.solve_mpc_qp_fused_cuda.launches_cr)
    cr_cfg = dataclasses.replace(cfg.solver, stage_solver="cr")
    out, fl = admm_cuda.solve_mpc_qp_fused(*args, cr_cfg, cfg, model)
    ref, fl_ref = admm_cuda.solve_mpc_qp_fused(*args, cfg.solver, cfg, model)
    assert (admm_cuda.solve_mpc_qp_fused_cuda.launches,
            admm_cuda.solve_mpc_qp_fused_cuda.launches_cr) == n
    np.testing.assert_array_equal(out.status.numpy(), ref.status.numpy())
    np.testing.assert_allclose(out.r_prim.numpy(), ref.r_prim.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(out.U[:, 0, 0].numpy(), ref.U[:, 0, 0].numpy(),
                               atol=3e-3)
    assert torch.equal(fl, fl_ref)
    raw = admm_cuda.solve_mpc_qp_fused_plain(*args, cr_cfg, cfg, model)
    assert torch.equal(raw[0][:, :-1, 3:], out.U)


def test_cr_rollout_matches_schur_rollout(sc):
    """4 closed-loop steps of B = 8 lanes from feasible_starts with CR and
    with Schur.  Bars, set before the first run: no failed lane in either,
    every lane's final s within 0.05 m of the Schur rollout's, and the
    accepted lane-steps differ by at most 1 of 32."""
    cfg, model = sc["tcfg"], sc["tmodel"]
    wp, ey = tsim.feasible_starts(sc["tgrid"], sc["tpath"], cfg, model, 8,
                                  np.random.default_rng(3))
    fleet = tsim.init_fleet(sc["tpath"], cfg.N, 8, e_y0=ey, wp_id0=wp)
    cr_cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, stage_solver="cr"))
    run = lambda c: tsim.simulate_fleet(sc["tgrid"], sc["tpath"], c, model,
                                        SimConfig(max_steps=4), fleet,
                                        table=sc["table"])
    cr, schur = run(cr_cfg), run(cfg)
    assert not cr.final_state.failed.any()
    assert not schur.final_state.failed.any()
    ds = (cr.final_state.s - schur.final_state.s).abs()
    assert float(ds.max()) <= 0.05, ds
    assert abs(int(cr.log.ok.sum()) - int(schur.log.ok.sum())) <= 1


# The lane of the batch below (lane 5: wp_id 65, e_y 0.025 m) whose speed
# command no pair of float32 solvers holds to 3e-3: its QP is certified
# infeasible (violation floor 8.017e-2, far above feas_tol 5e-3, so every
# solver rejects it: status MAX_ITER, r_prim 7.27e-2) and the budget leaves
# its least-violation point unconverged (r_dual 28-104), so rounding sets
# U[0, 0].  On the same inputs (tools/cr_lane.py): the port's CR 0.972058,
# its Schur 0.981117, the JAX CR kernel 0.978339, the JAX Schur kernel
# 0.978855, the JAX XLA solver 0.984365, a float64 ADMM to 1e-10 0.974681
# and the port's CR algorithm in float64 0.979165; one ulp on one input
# moves the port's CR across 0.972058-0.987023.  At 30 x 1 + 0 the port's
# CR and the JAX CR kernel agree to 5e-6 (0.974684 / 0.974689).  Summing the
# x-row diagonal of D in the JAX CR kernel's order moves the port's CR to
# 0.975421, and then the port's CR and Schur part by 6.84e-3 on the same
# lane from the port's own inputs (test_fused_cr_matches_fused_schur).
PINCH_LANE = 5


@pytest.fixture(scope="module")
def fused_cr_pair(sc):
    """K1's CR plain version and the JAX fused CR kernel in interpret mode
    (minutes on the CPU) on Sim_Track B = 8, N = 30: ``(out, ref)``."""
    from multi_purpose_mpc_tpu.models.bicycle import init_car_state as jinit
    from multi_purpose_mpc_tpu.mpc import (kappa_predictions as jkappa,
                                           mpc_corridor, mpc_locate as jlocate)
    from multi_purpose_mpc_tpu.ops.admm_pallas import solve_mpc_qp_fused
    from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index

    s = jax_scenario()
    path, cfg, model = s["path"], s["mpc_cfg"], s["model_cfg"]
    states = jax.vmap(lambda i: jinit(path, cfg.N, e_y=0.005 * i,
                                      wp_id=13 * i))(jnp.arange(8))
    located = jax.vmap(lambda st: jlocate(st, path))(states)
    corridor = jax.vmap(lambda w: mpc_corridor(w, path, s["grid"], cfg, model,
                                               s["segs"]))(located[0])
    wp_id, e_y, e_psi = located
    idxs = jax.vmap(lambda w: gather_waypoint_index(path, w,
                                                    jnp.arange(cfg.N)))(wp_id)
    x0 = jnp.stack([e_y, e_psi, jnp.zeros_like(e_y)], -1)
    kp = jax.vmap(lambda u: jkappa(u, cfg.N))(states.u_seq)
    args = (path.v_ref[idxs], path.kappa[idxs], path.seg_dist[idxs],
            corridor.lb, corridor.ub, x0, kp)
    ref = solve_mpc_qp_fused(*args, states.solver,
                             dataclasses.replace(cfg.solver, stage_solver="cr"),
                             cfg, model, lanes=8, interpret=True)
    tcfg = sc["tcfg"]
    out, _ = admm_cuda.solve_mpc_qp_fused(
        *(torch.tensor(np.asarray(a)) for a in args),
        interop.solver_carry(states.solver),
        dataclasses.replace(tcfg.solver, stage_solver="cr"), tcfg,
        sc["tmodel"])
    return out, ref


@pytest.mark.slow
@pytest.mark.kernel
def test_fused_cr_matches_jax_fused_cr_kernel(fused_cr_pair):
    """K1's CR plain version against the JAX fused CR kernel in interpret
    mode, Sim_Track B = 8, N = 30, with the bars of
    tests/test_admm_pallas.py's fused tests: status equal and r_prim within
    1e-3 on every lane, U[:, 0, 0] within 3e-3 on every lane but
    :data:`PINCH_LANE` (the next test)."""
    out, ref = fused_cr_pair
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.r_prim.numpy(), np.asarray(ref.r_prim),
                               atol=1e-3)
    rest = np.arange(8) != PINCH_LANE
    np.testing.assert_allclose(out.U[:, 0, 0].numpy()[rest],
                               np.asarray(ref.U[:, 0, 0])[rest], atol=3e-3)


@pytest.mark.slow
@pytest.mark.kernel
@pytest.mark.xfail(strict=True, reason=(
    "lane 5 is a certified-infeasible pinch-point QP (floor 8.017e-2, "
    "rejected by every solver) left unconverged by the budget: its speed "
    "command rides on float32 rounding (port CR 0.972058, JAX CR kernel "
    "0.978339, JAX XLA 0.984365, float64 0.974681; one ulp on one input "
    "moves the port across 0.972058-0.987023), test_torch_cr.PINCH_LANE"))
def test_fused_cr_speed_at_pinch_lane(fused_cr_pair):
    out, ref = fused_cr_pair
    assert abs(float(out.U[PINCH_LANE, 0, 0])
               - float(ref.U[PINCH_LANE, 0, 0])) <= 3e-3
