"""One step of the float64 oracle's lap through four float32 solvers, and
how far float32 rounding alone moves the port's answer there.

    JAX_PLATFORMS=cpu python tools/oracle_pinch.py [--cr] [STEP ...]   # default 100

For each step of ``tests/data/torch_oracle_lap.npz`` (tools/oracle_lap.py)
the QP is built from the oracle's pre-step state by the port (locate,
horizon block, corridor selection; a fresh solver carry) and solved by

(a) the port's ``ops/admm_cuda.solve_mpc_qp_fused`` (plain version of K1),
(b) the JAX package's fused TPU kernel ``admm_pallas.solve_mpc_qp_fused``
    in interpret mode,
(c) the JAX package's XLA solver ``ops/ltv_qp.solve_ltv_qp``,
(d) the port's ``ops/ltv_qp.solve_ltv_qp``, the counterpart of (c);

then (a) once more on 16 copies of the QP, each with one input moved by one
ulp (e_y, e_psi, one v_ref or one corridor lower bound), and in float64.
Prints the speed command v and r_prim of each beside the oracle's v.
``--cr``: (a), its one-ulp moves and its float64 run, and (b), take the
cyclic-reduction stage solver (K1-CR's plain version, the JAX CR kernel).
Takes ~10 min on the CPU (the interpret-mode kernel).  Imports JAX: a tool
for the parity record, not part of the port.
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

from multi_purpose_mpc_tpu.config import SolverConfig as JSolver  # noqa: E402
from multi_purpose_mpc_tpu.config import sim_track_preset as jpreset  # noqa: E402
from multi_purpose_mpc_tpu.mpc import assemble_ltv_qp as jassemble  # noqa: E402
from multi_purpose_mpc_tpu.ops import admm_pallas  # noqa: E402
from multi_purpose_mpc_tpu.ops.constraints import Corridor as JCorridor  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry as jcarry  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import solve_ltv_qp as jsolve  # noqa: E402
from multi_purpose_mpc_tpu_torch.mpc import (  # noqa: E402
    assemble_ltv_qp, kappa_predictions, mpc_locate)
from multi_purpose_mpc_tpu_torch.ops import admm_cuda, ltv_qp  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (  # noqa: E402
    corridor_select_from_block, gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.simulation import (  # noqa: E402
    init_fleet, static_horizon_table)
from tools.oracle_lap import FIXTURE, scenario  # noqa: E402

ULP_COPIES = 17  # the QP as it is, then 16 one-ulp moves


def qp_inputs(sc, lap, steps, table):
    """The port's QP inputs at the oracle's pre-step states ``steps``."""
    path, cfg, model = sc["path"], sc["cfg"], sc["model"]
    idx = np.asarray(steps)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    st = dataclasses.replace(
        init_fleet(path, cfg.N, len(idx)), x=f32(lap["pre_x"][idx]),
        y=f32(lap["pre_y"][idx]), psi=f32(lap["pre_psi"][idx]),
        s=f32(lap["pre_s"][idx]),
        u_seq=f32(lap["pre_u"][idx].reshape(len(idx), -1)),
        infeasibility_count=torch.as_tensor(lap["pre_ic"][idx],
                                            dtype=torch.int32))
    wp, e_y, e_psi = mpc_locate(st, path)
    blk = gather_horizon_block(table, wp)
    cor = corridor_select_from_block(blk, cfg, model.safety_margin)
    v, k, ds = solver_inputs_from_block(blk, cfg.max_segments)
    return dict(v=v, k=k, ds=ds, lb=cor.lb, ub=cor.ub, e_y=e_y, e_psi=e_psi,
                kp=kappa_predictions(st.u_seq, cfg.N), warm=st.solver, cor=cor)


def fused(sc, q, lb=None):
    x0 = torch.stack([q["e_y"], q["e_psi"], torch.zeros_like(q["e_y"])], -1)
    cfg = sc["cfg"]
    return admm_cuda.solve_mpc_qp_fused(
        q["v"], q["k"], q["ds"], q["lb"] if lb is None else lb, q["ub"], x0,
        q["kp"], q["warm"], cfg.solver, cfg, sc["model"])[0]


def main(steps, cr=False):
    sc = scenario()
    lap = dict(np.load(FIXTURE))
    if cr:
        sc["cfg"] = dataclasses.replace(sc["cfg"], solver=dataclasses.replace(
            sc["cfg"].solver, stage_solver="cr"))
    cfg, model = sc["cfg"], sc["model"]
    table = static_horizon_table(sc["grid"], sc["path"], cfg, model)
    q = qp_inputs(sc, lap, steps, table)
    sol_a = fused(sc, q)
    sol_d = ltv_qp.solve_ltv_qp(
        assemble_ltv_qp(cfg, model, q["e_y"], q["e_psi"], q["kp"], q["cor"],
                        (q["v"], q["k"], q["ds"])), cfg.solver, q["warm"])

    _, _, jmodel, jcfg, _, _ = jpreset(os.path.join(REPO, "assets", "maps"))
    jcfg = dataclasses.replace(
        jcfg, Q=cfg.Q, QN=cfg.QN, R=cfg.R, solver_backend="xla",
        solver=JSolver(iterations=cfg.solver.iterations,
                       rho_updates=cfg.solver.rho_updates,
                       polish_iters=cfg.solver.polish_iters,
                       stage_solver=cfg.solver.stage_solver))
    J = lambda t: jnp.asarray(t.numpy())
    x0 = torch.stack([q["e_y"], q["e_psi"], torch.zeros_like(q["e_y"])], -1)
    B = len(steps)
    sol_b, _ = admm_pallas.solve_mpc_qp_fused(
        J(q["v"]), J(q["k"]), J(q["ds"]), J(q["lb"]), J(q["ub"]), J(x0),
        J(q["kp"]), jax.vmap(lambda _: jcarry(cfg.N))(jnp.arange(B)),
        jcfg.solver, jcfg, jmodel, interpret=True, return_floor=True)

    def xla(i):
        cor = JCorridor(ub=J(q["ub"][i]), lb=J(q["lb"][i]), border_ub=None,
                        border_lb=None)
        qp = jassemble(None, jcfg, jmodel, None, J(q["e_y"][i]),
                       J(q["e_psi"][i]), J(q["kp"][i]), cor,
                       horizon=(J(q["v"][i]), J(q["k"][i]), J(q["ds"][i])))
        return jsolve(qp, jcfg.solver, warm=jcarry(cfg.N))

    for i, step in enumerate(steps):
        sol_c = xla(i)
        print(f"step {step}: oracle v {lap['v'][step]:.6f}")
        for label, v, rp in (
                (f"(a) port fused plain ({'K1-CR' if cr else 'K1'})",
                 sol_a.U[i, 0, 0], sol_a.r_prim[i]),
                (f"(b) JAX fused {'CR ' if cr else ''}TPU kernel, interpret",
                 sol_b.U[i, 0, 0],
                 sol_b.r_prim[i]),
                ("(c) JAX XLA solver", sol_c.U[0, 0], sol_c.r_prim),
                ("(d) port solve_ltv_qp", sol_d.U[i, 0, 0], sol_d.r_prim[i])):
            print(f"  {label:38s} v {float(v):.6f}  r_prim {float(rp):.4e}")

        # one ulp on one input at a time, then float64
        one = {key: (val[i:i + 1].expand(ULP_COPIES, *val.shape[1:]).clone()
                     if isinstance(val, torch.Tensor) else val)
               for key, val in q.items() if key not in ("cor", "warm")}
        one["warm"] = q["warm"].take(torch.full((ULP_COPIES,), i))
        up = lambda t: torch.nextafter(t, torch.full_like(t, np.inf))
        dn = lambda t: torch.nextafter(t, torch.full_like(t, -np.inf))
        one["e_y"][1], one["e_y"][2] = up(one["e_y"][1]), dn(one["e_y"][2])
        one["e_psi"][3], one["e_psi"][4] = up(one["e_psi"][3]), dn(one["e_psi"][4])
        for j in range(6):
            one["v"][5 + j, 3 * j] = up(one["v"][5 + j, 3 * j])
            one["lb"][11 + j, 2 + 4 * j] = dn(one["lb"][11 + j, 2 + 4 * j])
        vv = fused(sc, one).U[:, 0, 0].numpy()
        print(f"  one ulp moved: v in [{vv.min():.6f}, {vv.max():.6f}], "
              f"max |v - oracle| {np.abs(vv - lap['v'][step]).max():.3e}")
        d64 = {key: (val[:1].double() if isinstance(val, torch.Tensor) else val)
               for key, val in one.items() if key != "warm"}
        w = one["warm"]
        d64["warm"] = type(w)(**{f.name: getattr(w, f.name)[:1].double()
                                 for f in dataclasses.fields(w)})
        s64 = fused(sc, d64)
        print(f"  the same algorithm in float64: v {float(s64.U[0, 0, 0]):.6f}"
              f"  r_prim {float(s64.r_prim[0]):.4e}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main([int(a) for a in args if a != "--cr"] or [100], cr="--cr" in args)
