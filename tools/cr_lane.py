"""One lane of tests/test_torch_cr.py's fused CR batch through every
candidate solve, to tell a pinch-point QP from an arithmetic difference.

    JAX_PLATFORMS=cpu python tools/cr_lane.py [LANE]   # default 5

Builds test_fused_cr_matches_jax_fused_cr_kernel's batch (Sim_Track,
B = 8, N = 30, lanes from e_y = 0.005 i, wp_id = 13 i, the production
budget 30 x 6 + 10) and prints, for lane ``LANE``, the speed command
U[0, 0], r_prim, r_dual, status and violation floor of

(a) the port's fused plain version with CR (kernel K1-CR's twin) and
    (b) with Schur (K1's twin);
(c) the JAX package's fused CR kernel and (d) its fused Schur kernel, in
    interpret mode (~2 min each);
(e) the JAX package's XLA solver on the lane's assembled QP;
(f) the float64 dense solves of ``tests/oracle/qp.py`` (ADMM to 1e-10 and
    interior point), with their primal violation;
(g) (a) with the diagonal blocks summed in the JAX CR kernel's order;
(h) (a) in float64;
(i) (a) and (c) at a budget of one rho round and no polish;
(j) (a) on 16 copies of the QP, each with one input moved by one ulp.

Imports JAX: a tool for the parity record, not part of the port.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
jax.config.update("jax_platforms", "cpu")

from multi_purpose_mpc_tpu.models.bicycle import init_car_state as jinit  # noqa: E402
from multi_purpose_mpc_tpu.mpc import assemble_ltv_qp as jassemble  # noqa: E402
from multi_purpose_mpc_tpu.mpc import (kappa_predictions as jkappa,  # noqa: E402
                                       mpc_corridor, mpc_locate as jlocate)
from multi_purpose_mpc_tpu.ops import admm_pallas  # noqa: E402
from multi_purpose_mpc_tpu.ops.constraints import Corridor as JCorridor  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry as jcarry  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import materialize_dense  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import solve_ltv_qp as jsolve  # noqa: E402
from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index  # noqa: E402
from multi_purpose_mpc_tpu_torch import interop  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops import admm_cuda, ltv_qp  # noqa: E402
from tests.oracle.qp import primal_violation, solve_qp_f64, solve_qp_ip_f64  # noqa: E402
from tests.test_torch_setup import jax_scenario, port_configs  # noqa: E402

B = 8
ULP_COPIES = 17  # the QP as it is, then 16 one-ulp moves


def batch():
    """The test's JAX inputs, their port tensors and the configs."""
    s = jax_scenario()
    path, cfg, model = s["path"], s["mpc_cfg"], s["model_cfg"]
    states = jax.vmap(lambda i: jinit(path, cfg.N, e_y=0.005 * i,
                                      wp_id=13 * i))(jnp.arange(B))
    located = jax.vmap(lambda st: jlocate(st, path))(states)
    corridor = jax.vmap(lambda w: mpc_corridor(w, path, s["grid"], cfg, model,
                                               s["segs"]))(located[0])
    wp_id, e_y, e_psi = located
    idxs = jax.vmap(lambda w: gather_waypoint_index(path, w,
                                                    jnp.arange(cfg.N)))(wp_id)
    x0 = jnp.stack([e_y, e_psi, jnp.zeros_like(e_y)], -1)
    kp = jax.vmap(lambda u: jkappa(u, cfg.N))(states.u_seq)
    jargs = (path.v_ref[idxs], path.kappa[idxs], path.seg_dist[idxs],
             corridor.lb, corridor.ub, x0, kp)
    targs = tuple(torch.tensor(np.asarray(a)) for a in jargs)
    tmodel, tcfg = port_configs()
    return dict(jargs=jargs, targs=targs, jwarm=states.solver,
                twarm=interop.solver_carry(states.solver), jcfg=cfg,
                jmodel=model, tcfg=tcfg, tmodel=tmodel, wp_id=wp_id)


def port(b, solver, args=None, warm=None, cfg=None):
    """The port's fused plain version: (U, r_prim, r_dual, status, floor)."""
    sol, floor = admm_cuda.solve_mpc_qp_fused(
        *(args or b["targs"]), warm or b["twarm"], solver,
        cfg or b["tcfg"], b["tmodel"])
    return sol.U, sol.r_prim, sol.r_dual, sol.status, floor


def jax_kernel(b, solver):
    sol, floor = admm_pallas.solve_mpc_qp_fused(
        *b["jargs"], b["jwarm"], solver, b["jcfg"], b["jmodel"], lanes=B,
        interpret=True, return_floor=True)
    return sol.U, sol.r_prim, sol.r_dual, sol.status, floor


def line(label, out, i, ref=None):
    U, rp, rd, st, fl = (np.asarray(t) for t in out)
    v = float(U[i, 0, 0])
    extra = "" if ref is None else f"  |v - f64| {abs(v - ref):.3e}"
    print(f"  {label:50s} v {v:.6f}  r_prim {float(rp[i]):.4e}  r_dual "
          f"{float(rd[i]):.4e}  status {int(st[i])}  floor {float(fl[i]):.3e}"
          f"{extra}", flush=True)


def jax_cr_order_blocks(sq, rho_eq, rho_w, sigma):
    """``ltv_qp._build_blocks`` with the x-row diagonal summed as the JAX
    CR kernel sums it, (rho_eq AtA + diag_base) + rho_eq, where the port
    (and the JAX Schur kernel) sum rho_eq AtA + (diag_base + rho_eq)."""
    NX = ltv_qp.NX
    re = rho_eq[:, None, None, None]
    diag_base = (sq.Pd + sigma) + rho_w
    AtA = ltv_qp._seqsum(sq.AB[..., :, :, None] * sq.AB[..., :, None, :], -3)
    D_body = AtA * re + torch.diag_embed(diag_base[:, :-1])
    eyex = torch.diag_embed(torch.tensor([1.0] * NX + [0.0] * ltv_qp.NU,
                                         dtype=sq.AB.dtype))
    D_body = D_body + (rho_eq[:, None, None, None] * eyex)
    mask_x = eyex.diagonal()
    dN = mask_x * (diag_base[:, -1] + rho_eq[:, None]) + (1.0 - mask_x)
    D = torch.cat([D_body, torch.diag_embed(dN)[:, None]], 1)
    return D, -(re * sq.AB)


def main(i):
    b = batch()
    cfg = b["tcfg"].solver
    cr = dataclasses.replace(cfg, stage_solver="cr")
    jcr = dataclasses.replace(b["jcfg"].solver, stage_solver="cr")
    print(f"lane {i}: wp_id {int(b['wp_id'][i])}, e_y {0.005 * i:.3f} m, "
          f"budget {cfg.iterations} x {cfg.rho_updates} + {cfg.polish_iters}",
          flush=True)

    # (f) float64 dense solves of the lane's QP
    jcfg = dataclasses.replace(b["jcfg"], solver_backend="xla")
    J = lambda a: a[i]
    qp = jassemble(None, jcfg, b["jmodel"], None, J(b["jargs"][5])[0],
                   J(b["jargs"][5])[1], J(b["jargs"][6]),
                   JCorridor(ub=J(b["jargs"][4]), lb=J(b["jargs"][3]),
                             border_ub=None, border_lb=None),
                   horizon=tuple(J(a) for a in b["jargs"][:3]))
    P, q, A, l, u = materialize_dense(qp)
    N = b["tcfg"].N
    x_admm, _, _ = solve_qp_f64(P, q, A, l, u, eps=1e-10, max_iter=200000)
    x_ip, info = solve_qp_ip_f64(P, q, A, l, u)
    v64 = float(x_admm[3 * (N + 1)])
    print(f"  (f) float64 ADMM to 1e-10: v {v64:.6f}, violation "
          f"{primal_violation(A, l, u, x_admm):.3e}; interior point: v "
          f"{float(x_ip[3 * (N + 1)]):.6f}, violation "
          f"{primal_violation(A, l, u, x_ip):.3e}, gap {info['gap']:.1e}",
          flush=True)

    line("(a) port fused plain, CR (K1-CR's twin)", port(b, cr), i, v64)
    line("(b) port fused plain, Schur (K1's twin)", port(b, cfg), i, v64)
    # (e) the XLA solver from a fresh carry (the fused solves resume the
    # carried rho, which a fresh carry sets to cfg.rho)
    sol = jsolve(qp, jcfg.solver, warm=jcarry(N))
    print(f"  {'(e) JAX XLA solver':50s} v {float(sol.U[0, 0]):.6f}  r_prim "
          f"{float(sol.r_prim):.4e}  r_dual {float(sol.r_dual):.4e}  status "
          f"{int(sol.status)}  |v - f64| {abs(float(sol.U[0, 0]) - v64):.3e}",
          flush=True)
    orig = ltv_qp._build_blocks
    ltv_qp._build_blocks = jax_cr_order_blocks
    try:
        line("(g) (a), diagonal summed in the JAX CR order", port(b, cr), i,
             v64)
    finally:
        ltv_qp._build_blocks = orig
    w = b["twarm"]
    w64 = type(w)(**{f.name: getattr(w, f.name).double()
                     for f in dataclasses.fields(w)})
    line("(h) (a) in float64", port(b, cr, tuple(t.double() for t in
                                                 b["targs"]), w64), i, v64)

    # (j) one ulp on one input at a time
    one = [t[i:i + 1].expand(ULP_COPIES, *t.shape[1:]).clone()
           for t in b["targs"]]
    warm = w.take(torch.full((ULP_COPIES,), i))
    up = lambda t: torch.nextafter(t, torch.full_like(t, np.inf))
    dn = lambda t: torch.nextafter(t, torch.full_like(t, -np.inf))
    v_, _, _, lb, _, x0, _ = one
    x0[1, 0], x0[2, 0] = up(x0[1, 0]), dn(x0[2, 0])
    x0[3, 1], x0[4, 1] = up(x0[3, 1]), dn(x0[4, 1])
    for j in range(6):
        v_[5 + j, 3 * j] = up(v_[5 + j, 3 * j])
        lb[11 + j, 2 + 4 * j] = dn(lb[11 + j, 2 + 4 * j])
    for label, solver in (("CR", cr), ("Schur", cfg)):
        vv = port(b, solver, tuple(one), warm)[0][:, 0, 0].numpy()
        print(f"  (j) {label}, one ulp moved: v in [{vv.min():.6f}, "
              f"{vv.max():.6f}]", flush=True)

    short = dataclasses.replace(cr, rho_updates=1, polish_iters=0)
    jshort = dataclasses.replace(jcr, rho_updates=1, polish_iters=0)
    line("(i) (a) at 30 x 1 + 0", port(b, short), i)
    line("(i) (c) at 30 x 1 + 0", jax_kernel(b, jshort), i)
    line("(c) JAX fused CR kernel, interpret", jax_kernel(b, jcr), i, v64)
    line("(d) JAX fused Schur kernel, interpret",
         jax_kernel(b, b["jcfg"].solver), i, v64)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
