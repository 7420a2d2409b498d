"""How far apart the single-lane step's solver entries land, per step, on
the object API's two-call loop (tests/test_torch_api.py's scenario: the
Sim_Track preset, strictly convex weights R = diag(0.5, 0.01), the 40
pre-step states of the JAX API's loop).  CPU only; needs the JAX package.

    JAX_PLATFORMS=cpu python tools/api_solver_spread.py

At each state, with the carried rho reset to cfg.rho (the XLA solver's
start), three solves of the same QP:
  xla   JAX ``mpc_step`` (its XLA solver, the JAX API's ``get_control``);
  tpu   JAX ``mpc_pre_solve`` + ``solve_ltv_qp_pallas`` (the TPU entry,
        interpret mode, rolled stage loops), given the port's corridor;
  port  the port's ``mpc_step`` (kernel K3's plain version).
Prints the speed command's |difference| per pair (median, share within
1e-3, max) over the steps all three accept, and the acceptance.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np
    import torch

    from multi_purpose_mpc_tpu.mpc import mpc_locate as jlocate
    from multi_purpose_mpc_tpu.mpc import mpc_pre_solve as jpre_solve
    from multi_purpose_mpc_tpu.mpc import mpc_step as jmpc_step
    from multi_purpose_mpc_tpu.ops import constraints as jcons
    from multi_purpose_mpc_tpu.ops.admm_pallas import solve_ltv_qp_pallas
    from multi_purpose_mpc_tpu_torch.mpc import mpc_step
    from multi_purpose_mpc_tpu_torch.ops import constraints as tcons
    import tests.test_torch_api as T

    api = T.api.__wrapped__()
    jcfg, jp, jg = api["jmpc"].config, api["jrp"].path_data, api["jm"].grid
    tcfg, tp, tg = api["tmpc"].config, api["trp"].path_data, api["tm"].grid
    jmodel, tmodel = api["jcar"]._model_cfg, api["tcar"]._model_cfg
    rho = jcfg.solver.rho
    solver = dataclasses.replace(jcfg.solver, rolled_stage_loops=True)
    jstep = jax.jit(lambda s: jmpc_step(s, jp, jg, jcfg, jmodel))
    batch = lambda t: jax.tree.map(lambda a: a[None], t)
    v = {"xla": [], "tpu": [], "port": []}
    ok = {"xla": [], "tpu": [], "port": []}
    for jst in api["states"]:
        jst = jst.replace(solver=jst.solver.replace(
            rho=jax.numpy.asarray(rho, jax.numpy.float32)))
        out = mpc_step(T._port_state(jst), tp, tg, tcfg, tmodel)
        ref = jstep(jst)
        jcor = jcons.Corridor(*(jax.numpy.asarray(c[0].numpy())
                                for c in out.corridor))
        jqp, _ = jpre_solve(jst, jp, jg, jcfg, jmodel,
                            located=jlocate(jst, jp), corridor=jcor)
        sol = solve_ltv_qp_pallas(batch(jqp), batch(jst.solver), solver,
                                  lanes=8, interpret=True)
        v["port"].append(float(out.v[0]))
        ok["port"].append(bool(out.ok[0]))
        v["xla"].append(float(ref.v))
        ok["xla"].append(bool(ref.ok))
        v["tpu"].append(float(sol.U[0, 0, 0]))
        ok["tpu"].append(float(sol.r_prim[0]) <= jcfg.feas_tol)
    v = {k: np.array(a) for k, a in v.items()}
    ok = {k: np.array(a) for k, a in ok.items()}
    all_ok = ok["xla"] & ok["tpu"] & ok["port"]
    print(f"states {len(all_ok)}, accepted by all three {int(all_ok.sum())}; "
          + ", ".join(f"{k} accepts {int(a.sum())}" for k, a in ok.items()))
    for a, b in (("port", "tpu"), ("port", "xla"), ("tpu", "xla")):
        d = np.abs(v[a] - v[b])[all_ok]
        print(f"|v {a} - v {b}|: median {np.median(d):.3e}, within 1e-3 "
              f"{(d <= 1e-3).mean():.3f}, max {d.max():.3e}")


if __name__ == "__main__":
    main()
