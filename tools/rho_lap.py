"""The carried step size rho along the port's CPU laps of tests/test_modes.py,
and every step's solve held against the JAX package's fused TPU kernel.

    JAX_PLATFORMS=cpu python tools/rho_lap.py [MODE] [T]   # tracking, 170

Drives the port's single-car lap (``tools/oracle_lap.mode_scenario``: the
``tracking`` or ``time_optimal`` config, the production budget) on the CPU
one ``simulate_fleet`` step at a time, printing every 10th step's speed
command, acceptance and the adapted rho the fused solve carries to the
next step (the fused solve resumes it, as the JAX package's fused TPU
kernel does; its XLA solver restarts from ``cfg.rho``).  Then it takes the
QP of every pre-step state the lap visited (locate, horizon block,
corridor selection, the carried solver state) as one batch through

(a) the port's fused plain version (kernel K1's twin) and
(b) the JAX package's fused TPU kernel in interpret mode (minutes),

and prints how far they part: status agreement, the speed command, the
carried rho, and the mean speed command of each over the lap's states.  Imports JAX: a tool for the parity record, not part of the
port.
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
from multi_purpose_mpc_tpu.ops import admm_pallas  # noqa: E402
from multi_purpose_mpc_tpu.ops.ltv_qp import SolverCarry as JCarry  # noqa: E402
from multi_purpose_mpc_tpu_torch.config import SimConfig  # noqa: E402
from multi_purpose_mpc_tpu_torch.mpc import kappa_predictions, mpc_locate  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops import admm_cuda  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (  # noqa: E402
    corridor_select_from_block, gather_horizon_block, solver_inputs_from_block)
from multi_purpose_mpc_tpu_torch.simulation import (  # noqa: E402
    simulate_fleet, static_horizon_table)
from multi_purpose_mpc_tpu_torch.models.bicycle import init_car_state  # noqa: E402
from multi_purpose_mpc_tpu_torch.utils.tree import leaves, rebuild  # noqa: E402
from tools import oracle_lap as ol  # noqa: E402


def main(mode="tracking", T=170):
    ms = ol.mode_scenario()
    cfg, path, model = ms[mode], ms["path"], ms["model"]
    table = static_horizon_table(ms["grid"], path, cfg, model)
    st = init_car_state(path, cfg.N)
    states = []
    for t in range(T):
        states.append(st)
        res = simulate_fleet(ms["grid"], path, cfg, model,
                             SimConfig(max_steps=1), st, table=table)
        st, lg = res.final_state, res.log
        if t % 10 == 0:
            print(f"step {t}: s {float(st.s[0]):.3f} v {float(lg.v[0, 0]):.4f}"
                  f" ok {bool(lg.ok[0, 0])} carried rho "
                  f"{float(st.solver.rho[0]):.4e}", flush=True)

    # every pre-step state as one lane
    fleet = rebuild(states[0], [torch.cat(xs, 0)
                                for xs in zip(*map(leaves, states))])
    wp, e_y, e_psi = mpc_locate(fleet, path)
    blk = gather_horizon_block(table, wp)
    cor = corridor_select_from_block(blk, cfg, model.safety_margin)
    v, k, ds = solver_inputs_from_block(blk, cfg.max_segments)
    x0 = torch.stack([e_y, e_psi, torch.zeros_like(e_y)], -1)
    kp = kappa_predictions(fleet.u_seq, cfg.N)
    a, _ = admm_cuda.solve_mpc_qp_fused(v, k, ds, cor.lb, cor.ub, x0, kp,
                                        fleet.solver, cfg.solver, cfg, model)
    _, _, jmodel, jcfg, _, _ = jpreset(os.path.join(REPO, "assets", "maps"))
    s = cfg.solver
    jcfg = dataclasses.replace(
        jcfg, Q=cfg.Q, R=cfg.R, QN=cfg.QN,
        solver=JSolver(iterations=s.iterations, rho_updates=s.rho_updates,
                       polish_iters=s.polish_iters))
    J = lambda t: jnp.asarray(t.numpy())
    warm = JCarry(**{f.name: J(getattr(fleet.solver, f.name))
                     for f in dataclasses.fields(JCarry)})
    b = admm_pallas.solve_mpc_qp_fused(
        J(v), J(k), J(ds), J(cor.lb), J(cor.ub), J(x0), J(kp), warm,
        jcfg.solver, jcfg, jmodel, interpret=True)
    va, vb = a.U[:, 0, 0].numpy(), np.asarray(b.U[:, 0, 0])
    ra, rb = a.carry.rho.numpy(), np.asarray(b.carry.rho)
    print(f"{T} pre-step states, (a) port fused plain vs (b) JAX fused "
          f"kernel: status agree {np.mean(a.status.numpy() == np.asarray(b.status)):.4f}, "
          f"|dv| median {np.median(np.abs(va - vb)):.2e} max "
          f"{np.abs(va - vb).max():.2e}, carried rho ratio "
          f"{(ra / rb).min():.4f}-{(ra / rb).max():.4f}, rho (a) max "
          f"{ra.max():.4e} (b) max {rb.max():.4e}; mean speed command "
          f"(a) {va.mean():.4f} (b) {vb.mean():.4f}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args else "tracking", int(args[1]) if len(args) > 1 else 170)
