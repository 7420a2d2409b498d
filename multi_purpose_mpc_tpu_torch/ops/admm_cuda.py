"""Kernels K1 (fused QP assembly + ADMM + violation floor) and K3 (ADMM on
pre-assembled QPs), one warp per lane, sharing one ADMM core
(``csrc/admm_core.cuh``).

K3 replaces the Pallas TPU kernel ``_make_kernel`` with ``build=None``
(entry ``solve_ltv_qp_pallas``): per-lane weight sweeps and the escalation
pass under weights assemble their QPs outside the kernel, and
:func:`solve_ltv_qp_structured` (plain version
:func:`solve_ltv_qp_structured_plain`, kernel ``csrc/admm_structured.cu``)
solves them.  Both kernels end in :func:`finish_solve`.

K1 replaces the Pallas TPU kernel ``multi_purpose_mpc_tpu/ops/admm_pallas.py``
(``_make_kernel`` with ``build=_make_builder``, entry
``solve_mpc_qp_fused(..., return_floor=True)``).  For each lane it
assembles the N-stage LTV QP from the raw horizon data, runs the OSQP-style
ADMM (``cfg.rho_updates`` adaptive-rho rounds of ``cfg.iterations``
iterations, then the guarded ``cfg.polish_iters``-iteration polish) on the
block-tridiagonal stage system, and computes the certified
interval-reachability violation floor.

Three implementations of one function live here:

* :func:`solve_mpc_qp_fused_plain` — the plain PyTorch twin: the QP
  assembly below plus the solver core of :mod:`.ltv_qp`;
* :func:`solve_mpc_qp_fused_cuda` — the CUDA kernel ``csrc/admm_fused.cu``,
  which mirrors the twin's arithmetic operation for operation (both built
  without FMA contraction);
* :func:`solve_mpc_qp_fused` — the dispatcher: a CPU tensor goes to the
  twin, a CUDA tensor to the kernel (or the wrapper raises).  There is no
  fallback between the two.

What bounds the kernels on the card: every ADMM iteration runs two
recurrences over the N + 1 stages (the forward and backward substitutions
of the block-tridiagonal Schur factor), and the plain version's
left-to-right sums fix their order, so one lane's solve is a dependent
chain of ~190 x 2 x 31 stage steps at N = 30.  The design gives each lane
one warp: the stage-parallel work (assembly, right-hand side, projection,
dual updates, residuals) runs one stage per thread, the factorisation
stage by stage on the whole warp at once, and each substitution as a
block LDL' solve whose two chains carry only a stage's 3 x-rows, in one
thread's registers, between stage-parallel passes; per-lane maxima are
warp reductions.  The lane's state (109 floats a stage) lives in
shared memory, so the horizon is bounded by shared memory alone:
:data:`N_MAX`.  The kernels stay bound by the chain's latency: ~1.7 ms
for one lane at N = 30, and at B = 4096 two waves of 16 lanes per SM
(shared memory and 128 registers a thread bound the resident warps);
device-memory traffic is one read of ~1 KB of inputs and one write of
~2 KB of outputs per lane.

``SolverConfig(stage_solver="cr")`` selects block cyclic reduction as the
stage solver of both kernels and of both plain versions (the TPU kernel's
``factor_cr`` / ``solve_cr``; plain version :mod:`.cyclic_reduction`): a
solve is 2 x log2(M + 1) level steps over the M = 2^k - 1 >= N + 1 padded
stages, each level parallel over its stages, instead of 2 x N stage steps.
Each wrapper counts the launches of its Schur kernel (``launches``) and of
its CR kernel (``launches_cr``) apart.  The CR instantiation spreads each
level of its solve over the warp (a stage or a (stage, row) pair a
thread), and its lane holds 61 floats a stage, 30 a padded stage and 30 an
odd stage of any level (14,416 bytes at N = 30), so its horizon bound is
:data:`N_MAX_CR`; its launcher picks the lanes a block by CUDA's occupancy
calculator and the batch (:func:`occupancy` reports the choice).

Status and ``eps_d`` use the raw-data ``qmax`` bound of the fused TPU
entry point (not the structured solver's ``scale_d``), and the step size
starts from the carried ``warm.rho``, as the fused TPU kernel does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from multi_purpose_mpc_tpu_torch.config import MPCConfig, ModelConfig, SolverConfig
from multi_purpose_mpc_tpu_torch.ops.constraints import Corridor
from multi_purpose_mpc_tpu_torch.ops.cyclic_reduction import padded_stages
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (
    LTVQP, NW, NX, LTVSolution, SolverCarry, StageQP, _amax, admm_rounds,
    dual_residual, init_solver_carry, pack_carry, pack_qp, primal_residual,
    solver_status, unpack_carry)
from multi_purpose_mpc_tpu_torch.utils import kernels

_MAX_SMEM_BYTES = 232448  # dynamic shared memory of one block on Hopper


def lane_smem_bytes(N: int, cr: bool = False) -> int:
    """Shared memory of one lane at horizon N (``lane_floats`` in
    csrc/admm_core.cuh).  Schur: 66 floats a stage rounded up to 16 bytes,
    then the factor's G_n, 8 floats a stage and 7 rounded up to 16 bytes,
    and its inverses, 28 floats a stage.
    Cyclic reduction: 61 floats a stage, 30 a padded stage (the block and
    its inverse, the right-hand side and solution) and 30 an odd stage of
    any level (its two couplings), rounded up to 16 bytes."""
    S = N + 1
    if cr:
        M = padded_stages(S)
        pairs = M - (M + 1).bit_length() + 1
        return 4 * ((61 * S + 30 * M + 30 * pairs + 3) & ~3)
    return 4 * (((66 * S + 3) & ~3) + 8 * S + ((7 * S + 3) & ~3) + 28 * S)


# the longest horizons whose lane fits in one block's shared memory
N_MAX = max(N for N in range(1, 1024) if lane_smem_bytes(N) <= _MAX_SMEM_BYTES)
N_MAX_CR = max(N for N in range(1, 1024)
               if lane_smem_bytes(N, True) <= _MAX_SMEM_BYTES)


def _check_horizon(N: int, cr: bool = False) -> None:
    n_max = N_MAX_CR if cr else N_MAX
    if not 1 <= N <= n_max:
        solver = "cyclic reduction" if cr else "Schur"
        raise ValueError(
            f"horizon N={N} outside the {solver} kernel's 1..{n_max}: one "
            f"lane's solver state takes {lane_smem_bytes(N, cr)} bytes of "
            f"shared memory, a block at most {_MAX_SMEM_BYTES}")


# ---------------------------------------------------------------------------
# Plain PyTorch twin
# ---------------------------------------------------------------------------

def assemble_stage_qp(v, k, ds, lbc, ubc, x0, kp, mpc_cfg: MPCConfig,
                      model_cfg: ModelConfig):
    """In-kernel QP constructor of the fused solve (the TPU kernel's
    ``_make_builder``): (B, N) horizon data, (B, 3) measured spatial state
    -> ``(StageQP, floor)``."""
    Bsz, N = v.shape
    z, o = torch.zeros_like(v), torch.ones_like(v)
    Q0, Q1, Q2 = (float(q) for q in mpc_cfg.Q)
    QN0, QN1, QN2 = (float(q) for q in mpc_cfg.QN)
    R0, R1 = (float(r) for r in mpc_cfg.R)
    kmax = float(mpc_cfg.kappa_max(model_cfg.length))
    inf = math.inf
    z1 = torch.zeros((Bsz, 1), dtype=v.dtype, device=v.device)
    full = lambda val, n: torch.full((Bsz, n), val, dtype=v.dtype,
                                     device=v.device)

    # stage matrices [A_n | B_n] (spatial_bicycle_models.py:404-417)
    AB = torch.stack([
        torch.stack([o, ds, z, z, z], -1),
        torch.stack([-(k * k) * ds, o, z, z, ds], -1),
        torch.stack([-(k / v) * ds, z, o, -ds / (v * v), z], -1)], -2)
    # equality rhs: uq = B ur - f = (0, ds k, -2 ds / v)
    uq = torch.stack([z, ds * k, -2.0 * ds / v], -1)
    beq = torch.cat([-x0[:, None], uq], 1)
    Pd = torch.tensor([[Q0, Q1, Q2, R0, R1]] * N + [[QN0, QN1, QN2, 0.0, 0.0]],
                      dtype=v.dtype, device=v.device).expand(Bsz, N + 1, NW)
    # linear cost: corridor-centre e_y reference, input references
    ctr = 0.5 * (lbc + ubc)
    ey = torch.cat([z1, -Q0 * ctr[:, :-1], -QN0 * ctr[:, -1:]], 1)
    zc = torch.zeros_like(ey)
    qv = torch.stack([ey, zc, zc, torch.cat([-R0 * v, z1], 1),
                      torch.cat([-R1 * k, z1], 1)], -1)
    # bounds: e_y pinned at stage 0, corridor after; dynamic speed cap
    vmax_dyn = torch.clamp(torch.sqrt(mpc_cfg.ay_max / (kp.abs() + 1e-12)),
                           max=mpc_cfg.v_max)
    xmin, xmax = mpc_cfg.xmin, mpc_cfg.xmax
    lw = torch.stack([torch.cat([x0[:, 0:1], lbc], 1), full(xmin[1], N + 1),
                      full(xmin[2], N + 1),
                      torch.cat([full(mpc_cfg.v_min, N), full(-inf, 1)], 1),
                      torch.cat([full(-kmax, N), full(-inf, 1)], 1)], -1)
    uw = torch.stack([torch.cat([x0[:, 0:1], ubc], 1), full(xmax[1], N + 1),
                      full(xmax[2], N + 1),
                      torch.cat([vmax_dyn, full(inf, 1)], 1),
                      torch.cat([full(kmax, N), full(inf, 1)], 1)], -1)

    # certified violation floor by interval reachability; imported here
    # because mpc.py imports this module
    from multi_purpose_mpc_tpu_torch.mpc import corridor_violation_floor

    floor = corridor_violation_floor(x0[:, 0], x0[:, 1], (v, k, ds),
                                     Corridor(ubc, lbc, None, None), mpc_cfg,
                                     model_cfg)
    return StageQP(AB=AB, beq=beq, Pd=Pd, qv=qv, lw=lw, uw=uw), floor


def solve_mpc_qp_fused_plain(v_ref, kappa_ref, delta_s, lb_c, ub_c, x0,
                             kappa_pred, warm: SolverCarry,
                             cfg: SolverConfig, mpc_cfg: MPCConfig,
                             model_cfg: ModelConfig):
    """The twin: raw kernel outputs ``(W, Zw, Yeq, Yw, rho, r_prim, r_dual,
    floor)`` in the stage layout."""
    sq, floor = assemble_stage_qp(v_ref, kappa_ref, delta_s, lb_c, ub_c, x0,
                                  kappa_pred, mpc_cfg, model_cfg)
    (W, Zw, Yeq, Yw), rho = admm_rounds(sq, cfg, pack_carry(warm), warm.rho)
    rd, _ = dual_residual(sq, W, Yeq, Yw)
    return W, Zw, Yeq, Yw, rho, primal_residual(sq, W), rd, floor


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

class _SolverParams(ctypes.Structure):
    """Mirror of ``SolverParams`` in csrc/admm_core.cuh (passed by value)."""

    _fields_ = [("sigma", ctypes.c_float), ("alpha", ctypes.c_float),
                ("one_m_alpha", ctypes.c_float), ("eq_scale", ctypes.c_float),
                ("iterations", ctypes.c_int), ("rho_updates", ctypes.c_int),
                ("polish_iters", ctypes.c_int),
                ("polish_boost", ctypes.c_float)]


class _Params(ctypes.Structure):
    """Mirror of ``AdmmParams`` in csrc/admm_fused.cu (passed by value)."""

    _fields_ = [("s", _SolverParams),
                ("Q", ctypes.c_float * 3), ("QN", ctypes.c_float * 3),
                ("R", ctypes.c_float * 2), ("xmin", ctypes.c_float * 3),
                ("xmax", ctypes.c_float * 3), ("v_min", ctypes.c_float),
                ("v_max", ctypes.c_float), ("ay_max", ctypes.c_float),
                ("kmax", ctypes.c_float)]


def _solver_params(cfg: SolverConfig) -> _SolverParams:
    return _SolverParams(
        sigma=cfg.sigma, alpha=cfg.alpha, one_m_alpha=1.0 - cfg.alpha,
        eq_scale=cfg.rho_eq_scale, iterations=cfg.iterations,
        rho_updates=max(cfg.rho_updates, 1), polish_iters=cfg.polish_iters,
        polish_boost=cfg.polish_boost)


def _params(cfg: SolverConfig, mpc_cfg: MPCConfig, model_cfg: ModelConfig):
    f3 = ctypes.c_float * 3
    return _Params(
        s=_solver_params(cfg), Q=f3(*mpc_cfg.Q), QN=f3(*mpc_cfg.QN),
        R=(ctypes.c_float * 2)(*mpc_cfg.R), xmin=f3(*mpc_cfg.xmin),
        xmax=f3(*mpc_cfg.xmax), v_min=mpc_cfg.v_min, v_max=mpc_cfg.v_max,
        ay_max=mpc_cfg.ay_max, kmax=mpc_cfg.kappa_max(model_cfg.length))


def _library():
    lib = kernels.load("admm_fused")
    fn = lib.admm_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 + [
        _Params, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def solve_mpc_qp_fused_cuda(v_ref, kappa_ref, delta_s, lb_c, ub_c, x0,
                            kappa_pred, warm: SolverCarry,
                            cfg: SolverConfig, mpc_cfg: MPCConfig,
                            model_cfg: ModelConfig):
    """Launch ``admm_fused_kernel`` (its cyclic-reduction instantiation
    under ``cfg.stage_solver == "cr"``) on the current stream; same outputs
    as :func:`solve_mpc_qp_fused_plain`.  Raises on anything the kernel
    does not take, and on a failed launch."""
    dev = v_ref.device
    if dev.type != "cuda":
        raise ValueError(f"solve_mpc_qp_fused_cuda needs CUDA tensors, got {dev}")
    Bsz, N = v_ref.shape
    cr = cfg.stage_solver == "cr"  # any other value: Schur, as on the TPU
    _check_horizon(N, cr)
    W0, Zw0, Yeq0, Yw0 = (t.contiguous() for t in pack_carry(warm))
    ins = [("v_ref", v_ref, (Bsz, N)), ("kappa_ref", kappa_ref, (Bsz, N)),
           ("delta_s", delta_s, (Bsz, N)), ("lb_c", lb_c, (Bsz, N)),
           ("ub_c", ub_c, (Bsz, N)), ("kappa_pred", kappa_pred, (Bsz, N)),
           ("x0", x0, (Bsz, NX)), ("W0", W0, (Bsz, N + 1, NW)),
           ("Zw0", Zw0, (Bsz, N + 1, NW)), ("Yeq0", Yeq0, (Bsz, N + 1, NX)),
           ("Yw0", Yw0, (Bsz, N + 1, NW)), ("rho0", warm.rho, (Bsz,))]
    for name, t, shape in ins:
        _check(t, name, shape, dev)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    outs = (empty(Bsz, N + 1, NW), empty(Bsz, N + 1, NW),
            empty(Bsz, N + 1, NX), empty(Bsz, N + 1, NW), empty(Bsz),
            empty(Bsz), empty(Bsz), empty(Bsz))
    fn = _library()
    rc = fn(*(t.data_ptr() for _, t, _ in ins), *(t.data_ptr() for t in outs),
            Bsz, N, int(cr), _params(cfg, mpc_cfg, model_cfg),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "admm_fused_kernel")
    if cr:
        solve_mpc_qp_fused_cuda.launches_cr += 1
    else:
        solve_mpc_qp_fused_cuda.launches += 1
    return outs


solve_mpc_qp_fused_cuda.launches = 0
solve_mpc_qp_fused_cuda.launches_cr = 0


def occupancy(kernel: str, N: int, cr: bool) -> tuple:
    """``(lanes a block, lanes resident per SM)`` of K1 (``kernel="fused"``)
    or K3 (``"structured"``) at horizon N with the Schur or (``cr``) the
    cyclic-reduction stage solver: the launcher's own choice for a batch
    that fills the card (``launch_shape`` in csrc/admm_core.cuh) and CUDA's
    occupancy calculator for it.  Needs the card."""
    if kernel not in ("fused", "structured"):
        raise ValueError(
            f"kernel must be 'fused' or 'structured', got {kernel!r}")
    _check_horizon(N, cr)
    torch.cuda.init()
    fn = getattr(kernels.load(f"admm_{kernel}"), f"admm_{kernel}_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lanes, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(N, int(cr), ctypes.byref(lanes), ctypes.byref(per_sm))
    kernels.check_launch(rc, f"admm_{kernel}_occupancy")
    return lanes.value, per_sm.value


# ---------------------------------------------------------------------------
# Kernel K3: the structured solve of pre-assembled per-lane QPs
# ---------------------------------------------------------------------------

def solve_ltv_qp_structured_plain(sq: StageQP, warm: SolverCarry,
                                  cfg: SolverConfig):
    """K3's plain version: raw outputs ``(W, Zw, Yeq, Yw, rho, r_prim,
    r_dual)`` of the ADMM on the stage-layout QPs ``sq``, resuming the
    carried ``warm.rho`` as the TPU kernel does."""
    (W, Zw, Yeq, Yw), rho = admm_rounds(sq, cfg, pack_carry(warm), warm.rho)
    rd, _ = dual_residual(sq, W, Yeq, Yw)
    return W, Zw, Yeq, Yw, rho, primal_residual(sq, W), rd


def _structured_library():
    fn = kernels.load("admm_structured").admm_structured_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [
        _SolverParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def solve_ltv_qp_structured_cuda(sq: StageQP, warm: SolverCarry,
                                 cfg: SolverConfig):
    """Launch ``admm_structured_kernel`` (its cyclic-reduction instantiation
    under ``cfg.stage_solver == "cr"``) on the current stream; same outputs
    as :func:`solve_ltv_qp_structured_plain`.  Raises on anything the kernel
    does not take, and on a failed launch."""
    dev = sq.AB.device
    if dev.type != "cuda":
        raise ValueError(f"solve_ltv_qp_structured_cuda needs CUDA tensors, "
                         f"got {dev}")
    Bsz, N = sq.AB.shape[:2]
    cr = cfg.stage_solver == "cr"  # any other value: Schur, as on the TPU
    _check_horizon(N, cr)
    W0, Zw0, Yeq0, Yw0 = (t.contiguous() for t in pack_carry(warm))
    S5, S3 = (Bsz, N + 1, NW), (Bsz, N + 1, NX)
    ins = [("AB", sq.AB, (Bsz, N, NX, NW)), ("beq", sq.beq, S3),
           ("Pd", sq.Pd, S5), ("qv", sq.qv, S5), ("lw", sq.lw, S5),
           ("uw", sq.uw, S5), ("W0", W0, S5), ("Zw0", Zw0, S5),
           ("Yeq0", Yeq0, S3), ("Yw0", Yw0, S5), ("rho0", warm.rho, (Bsz,))]
    for name, t, shape in ins:
        _check(t, name, shape, dev)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    outs = (empty(*S5), empty(*S5), empty(*S3), empty(*S5), empty(Bsz),
            empty(Bsz), empty(Bsz))
    rc = _structured_library()(
        *(t.data_ptr() for _, t, _ in ins), *(t.data_ptr() for t in outs),
        Bsz, N, int(cr), _solver_params(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "admm_structured_kernel")
    if cr:
        solve_ltv_qp_structured_cuda.launches_cr += 1
    else:
        solve_ltv_qp_structured_cuda.launches += 1
    return outs


solve_ltv_qp_structured_cuda.launches = 0
solve_ltv_qp_structured_cuda.launches_cr = 0


# ---------------------------------------------------------------------------
# Dispatchers and the status / carry logic shared by K1 and K3
# ---------------------------------------------------------------------------

def solve_mpc_qp_fused(v_ref, kappa_ref, delta_s, lb_c, ub_c, x0, kappa_pred,
                       warm: SolverCarry, cfg: SolverConfig,
                       mpc_cfg: MPCConfig, model_cfg: ModelConfig):
    """Fully fused control-QP solve for a fleet: ``v_ref/kappa_ref/delta_s``
    (B, N) horizon data, ``lb_c/ub_c`` (B, N) corridor bounds of x_1..x_N,
    ``x0`` (B, 3) measured spatial state, ``kappa_pred`` (B, N).

    Returns ``(LTVSolution, floor)``.  CPU tensors run the plain twin, CUDA
    tensors the kernel.
    """
    if v_ref.device.type == "cpu":
        raw = solve_mpc_qp_fused_plain(v_ref, kappa_ref, delta_s, lb_c, ub_c,
                                       x0, kappa_pred, warm, cfg, mpc_cfg,
                                       model_cfg)
    else:
        raw = solve_mpc_qp_fused_cuda(v_ref, kappa_ref, delta_s, lb_c, ub_c,
                                      x0, kappa_pred, warm, cfg, mpc_cfg,
                                      model_cfg)
    return finish(raw, v_ref, kappa_ref, lb_c, ub_c, cfg, mpc_cfg)


def finish(raw, v_ref, kappa_ref, lb_c, ub_c, cfg: SolverConfig,
           mpc_cfg: MPCConfig):
    """``(LTVSolution, floor)`` of the fused solve from its raw outputs.

    ``eps_d`` uses the raw-data bound ``qmax`` of the fused TPU entry
    point, not the structured solver's ``scale_d``."""
    *raw7, floor = raw
    Q0, QN0 = float(mpc_cfg.Q[0]), float(mpc_cfg.QN[0])
    R0, R1 = (float(r) for r in mpc_cfg.R)
    ctr = 0.5 * (lb_c + ub_c)
    qmax = torch.maximum(_amax(ctr) * max(Q0, QN0),
                         torch.maximum(_amax(v_ref) * R0, _amax(kappa_ref) * R1))
    return finish_solve(raw7, qmax, cfg), floor


def solve_ltv_qp_structured(qp: LTVQP, warm: SolverCarry,
                            cfg: SolverConfig) -> LTVSolution:
    """Batched solve of pre-assembled QPs (the TPU entry
    ``solve_ltv_qp_pallas``): CPU tensors run the plain version, CUDA
    tensors kernel K3.  The step size resumes from ``warm.rho`` whatever
    ``cfg.carry_rho`` says, and ``eps_d`` uses max(|q_x|, |q_u|), as the
    TPU entry does."""
    sq = pack_qp(qp)
    if sq.AB.device.type == "cpu":
        raw = solve_ltv_qp_structured_plain(sq, warm, cfg)
    else:
        raw = solve_ltv_qp_structured_cuda(sq, warm, cfg)
    return finish_solve(raw, _amax(sq.qv), cfg)


def finish_solve(raw, qmax, cfg: SolverConfig) -> LTVSolution:
    """Status, eps and carry from the raw solver outputs ``(W, Zw, Yeq, Yw,
    rho, r_prim, r_dual)`` and the per-lane linear-cost bound ``qmax``: a
    non-finite lane is DIVERGED and its carry resets to the fresh carry."""
    W, Zw, Yeq, Yw, rho, rp, rd = raw
    Bsz, N = W.shape[0], W.shape[1] - 1
    finite = torch.isfinite(W).flatten(1).all(1)
    eps_p = cfg.eps_abs + cfg.eps_rel * _amax(W)
    eps_d = cfg.eps_abs + cfg.eps_rel * qmax
    status = solver_status(finite, (rp <= eps_p) & (rd <= eps_d))
    carry = unpack_carry(W, Zw, Yeq, Yw, rho).select(
        finite, init_solver_carry(N, Bsz, cfg.rho, W.device))
    return LTVSolution(X=W[..., :NX], U=W[:, :-1, NX:], status=status,
                       r_prim=rp, r_dual=rd, carry=carry)
