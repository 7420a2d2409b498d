"""Count the torch ops one object-API control step dispatches outside its
kernels, part by part, on the CPU (the Sim_Track preset, tests/test_api.py's
construction; no card needed).  Each op is one or more kernel launches on
the card, where the step is host-bound (PERF.md §5).

    python tools/api_step_ops.py

The kernels' calls (K4, K8, K2, K3) count as one op each; their plain
versions' ops are left out.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from multi_purpose_mpc_tpu_torch import api, mpc
    from multi_purpose_mpc_tpu_torch.config import sim_track_preset
    from multi_purpose_mpc_tpu_torch.models.bicycle import horizon_indices
    from multi_purpose_mpc_tpu_torch.ops import admm_cuda
    from multi_purpose_mpc_tpu_torch.ops import constraints as cons
    from multi_purpose_mpc_tpu_torch.ops.corridor_extract import (
        horizon_pixels, horizon_segments_from_table)
    from multi_purpose_mpc_tpu_torch.ops.horizon_table import horizon_block_from_segments
    from multi_purpose_mpc_tpu_torch.ops.ltv_qp import pack_qp
    from multi_purpose_mpc_tpu_torch.ops.path import gather_waypoint_index

    map_cfg, path_cfg, model, cfg, speed, obstacles = sim_track_preset(
        os.path.join(REPO, "assets", "maps"))
    m = api.Map(map_cfg.file_path, map_cfg.origin, map_cfg.resolution,
                device="cpu")
    rp = api.ReferencePath(m, path_cfg.wp_x, path_cfg.wp_y,
                           path_cfg.resolution, path_cfg.smoothing_distance,
                           path_cfg.max_width, path_cfg.circular)
    m.add_obstacles([api.Obstacle(*o) for o in obstacles])
    car = api.BicycleModel(rp, model.length, model.width, model.Ts)
    kmax = np.tan(cfg.delta_max) / car.length
    ctrl = api.MPC(car, cfg.N, np.diag(cfg.Q), np.diag(cfg.R), np.diag(cfg.QN),
                   {"xmin": np.full(3, -np.inf), "xmax": np.full(3, np.inf)},
                   {"umin": np.array([0.0, -kmax]),
                    "umax": np.array([cfg.v_max, kmax])}, cfg.ay_max)
    rp.compute_speed_profile(speed)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def ops(fn):
        with Count() as c:
            out = fn()
        return c.n, out

    st, path, grid, mo = car.state, rp.path_data, m.grid, car._model_cfg
    sm, S, N = mo.safety_margin, cfg.max_segments, cfg.N
    rows = []
    n, located = ops(lambda: mpc.mpc_locate(st, path))
    rows.append(("locate", n))
    scan, table = cons.corridor_tables(grid, path, N, cfg.n_scan_samples, S)
    wp = located[0].long() + 1

    def corridor_inputs():
        idx = gather_waypoint_index(path, wp[:, None], torch.arange(N)[None, :])
        return idx, horizon_pixels(scan, idx)

    n, (idx, (px, py)) = ops(corridor_inputs)
    rows.append(("horizon pixels of the scanline table", n))
    vals = grid.occ[py.long(), px.long()]  # K4's output
    segs = horizon_segments_from_table(vals, scan, idx, 2.0 * sm, S)
    rows.append(("free runs (K8)", 1))
    n, blk = ops(lambda: horizon_block_from_segments(
        table, gather_waypoint_index(path, wp, 0), segs))
    rows.append(("block write", n))
    corridor = cons.update_path_constraints(grid, path, wp, N, 2.0 * sm, sm)
    hidx = horizon_indices(path, located[0], N)
    horizon = (path.v_ref[hidx], path.kappa[hidx], path.seg_dist[hidx])
    kp = mpc.kappa_predictions(st.u_seq, N)
    n, _ = ops(lambda: mpc.kappa_predictions(st.u_seq, N))
    rows.append(("kappa predictions", n))
    n, qp = ops(lambda: mpc.assemble_ltv_qp(cfg, mo, located[1], located[2],
                                            kp, corridor, horizon))
    rows.append(("assembly", n))
    n, _ = ops(lambda: mpc.corridor_violation_floor(
        located[1], located[2], horizon, corridor, cfg, mo))
    rows.append(("violation floor", n))
    n, sq = ops(lambda: pack_qp(qp))
    rows.append(("pack_qp", n))
    raw = admm_cuda.solve_ltv_qp_structured_plain(sq, st.solver, cfg.solver)
    n, sol = ops(lambda: admm_cuda.finish_solve(raw, admm_cuda._amax(sq.qv),
                                                cfg.solver))
    rows.append(("status and carry", n))
    aux = (*located, corridor, torch.zeros(1))
    n, out = ops(lambda: mpc.mpc_post_solve(st, sol, aux, cfg, mo))
    rows.append(("accept / replay", n))
    n, _ = ops(lambda: mpc.predict_world_positions(path, out.state.wp_id,
                                                   out.X_pred))
    rows.append(("prediction", n))
    rows.append(("kernels K4, K2, K3", 3))
    total = sum(n for _, n in rows)
    for name, n in rows:
        print(f"{name:36s} {n:5d}")
    print(f"{'total':36s} {total:5d}")


if __name__ == "__main__":
    main()
