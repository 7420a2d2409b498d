"""Kernel K1: fused QP assembly + ADMM + violation floor, one lane per thread.

Replaces the Pallas TPU kernel ``multi_purpose_mpc_tpu/ops/admm_pallas.py``
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

What bounds the kernel on the card: one thread runs a whole lane — about
3.5k floats of stage data, factors (Sinv alone is 31 x 25), iterates and
the polish candidate — so the state lives in local memory (L1/L2-cached,
interleaved per thread), and B = 4096 lanes are only 128 warps, one per SM
at 32-thread blocks.  Each ADMM iteration is a dependent chain of ~4k
scalar flops per lane through that local memory: the kernel is bound by
local-memory latency at low occupancy, not by device-memory bandwidth
(one read of ~1 KB of inputs and one write of ~2 KB of outputs per lane).
The design keeps the first version simple and exact: a later PR spreads a
lane over several threads (the 5x5 stage algebra) and keeps the factors
in registers and shared memory.

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
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (
    NW, NX, LTVSolution, SolverCarry, StageQP, _amax, admm_rounds,
    dual_residual, init_solver_carry, pack_carry, primal_residual,
    solver_status, unpack_carry)
from multi_purpose_mpc_tpu_torch.utils import kernels

N_MAX = 32  # horizon bound of the kernel's per-lane local arrays


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

class _Params(ctypes.Structure):
    """Mirror of ``AdmmParams`` in csrc/admm_fused.cu (passed by value)."""

    _fields_ = [("sigma", ctypes.c_float), ("alpha", ctypes.c_float),
                ("one_m_alpha", ctypes.c_float), ("eq_scale", ctypes.c_float),
                ("iterations", ctypes.c_int), ("rho_updates", ctypes.c_int),
                ("polish_iters", ctypes.c_int),
                ("polish_boost", ctypes.c_float),
                ("Q", ctypes.c_float * 3), ("QN", ctypes.c_float * 3),
                ("R", ctypes.c_float * 2), ("xmin", ctypes.c_float * 3),
                ("xmax", ctypes.c_float * 3), ("v_min", ctypes.c_float),
                ("v_max", ctypes.c_float), ("ay_max", ctypes.c_float),
                ("kmax", ctypes.c_float)]


def _params(cfg: SolverConfig, mpc_cfg: MPCConfig, model_cfg: ModelConfig):
    f3 = ctypes.c_float * 3
    return _Params(
        sigma=cfg.sigma, alpha=cfg.alpha, one_m_alpha=1.0 - cfg.alpha,
        eq_scale=cfg.rho_eq_scale, iterations=cfg.iterations,
        rho_updates=max(cfg.rho_updates, 1), polish_iters=cfg.polish_iters,
        polish_boost=cfg.polish_boost, Q=f3(*mpc_cfg.Q), QN=f3(*mpc_cfg.QN),
        R=(ctypes.c_float * 2)(*mpc_cfg.R), xmin=f3(*mpc_cfg.xmin),
        xmax=f3(*mpc_cfg.xmax), v_min=mpc_cfg.v_min, v_max=mpc_cfg.v_max,
        ay_max=mpc_cfg.ay_max, kmax=mpc_cfg.kappa_max(model_cfg.length))


def _library():
    lib = kernels.load("admm_fused")
    fn = lib.admm_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int, ctypes.c_int,
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
    """Launch ``admm_fused_kernel`` on the current stream; same outputs as
    :func:`solve_mpc_qp_fused_plain`.  Raises on anything the kernel does
    not take, and on a failed launch."""
    dev = v_ref.device
    if dev.type != "cuda":
        raise ValueError(f"solve_mpc_qp_fused_cuda needs CUDA tensors, got {dev}")
    Bsz, N = v_ref.shape
    if not 1 <= N <= N_MAX:
        raise ValueError(f"horizon N={N} outside the kernel's 1..{N_MAX}")
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
            Bsz, N, _params(cfg, mpc_cfg, model_cfg),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(rc, "admm_fused_kernel")
    solve_mpc_qp_fused_cuda.launches += 1
    return outs


solve_mpc_qp_fused_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatcher and the status / carry logic shared by both
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
    """Status, eps and carry of the fused solve from its raw outputs.

    ``eps_d`` uses the raw-data bound ``qmax`` of the fused TPU entry
    point, not the structured solver's ``scale_d``; a non-finite lane's
    carry resets to the fresh carry."""
    W, Zw, Yeq, Yw, rho, rp, rd, floor = raw
    Bsz, N = v_ref.shape
    finite = torch.isfinite(W).flatten(1).all(1)
    eps_p = cfg.eps_abs + cfg.eps_rel * _amax(W)
    Q0, QN0 = float(mpc_cfg.Q[0]), float(mpc_cfg.QN[0])
    R0, R1 = (float(r) for r in mpc_cfg.R)
    ctr = 0.5 * (lb_c + ub_c)
    qmax = torch.maximum(_amax(ctr) * max(Q0, QN0),
                         torch.maximum(_amax(v_ref) * R0, _amax(kappa_ref) * R1))
    eps_d = cfg.eps_abs + cfg.eps_rel * qmax
    status = solver_status(finite, (rp <= eps_p) & (rd <= eps_d))
    carry = unpack_carry(W, Zw, Yeq, Yw, rho).select(
        finite, init_solver_carry(N, Bsz, cfg.rho, W.device))
    sol = LTVSolution(X=W[..., :NX], U=W[:, :-1, NX:], status=status,
                      r_prim=rp, r_dual=rd, carry=carry)
    return sol, floor
