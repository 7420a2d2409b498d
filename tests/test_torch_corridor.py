"""Port parity, corridor layer: the horizon table and kernel K2's plain twin
(ops/corridor_cuda.corridor_select_plain) against the JAX package's XLA
corridor path (constraints.corridor_from_segments) on Sim_Track.

The twin follows the TPU kernel's formulas (cross-product sign, sqrt,
_BIG, strict "<"), the XLA path atan2/hypot/argmin: the bars are the ones
tests/test_corridor_pallas.py holds the TPU kernel to (ub/lb 2e-5,
borders 5e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_purpose_mpc_tpu.mpc import mpc_corridor as jmpc_corridor
from multi_purpose_mpc_tpu.ops.constraints import SegmentCandidates as JSegs
from multi_purpose_mpc_tpu.ops.horizon_table import (
    build_horizon_table as jbuild_table)
from multi_purpose_mpc_tpu.ops.path import (
    build_reference_path as jbuild_path, gather_waypoint_index as jgather)

from multi_purpose_mpc_tpu_torch import interop
from multi_purpose_mpc_tpu_torch.mpc import mpc_corridor
from multi_purpose_mpc_tpu_torch.ops.constraints import SegmentCandidates
from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import (
    corridor_select, corridor_select_plain)
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (
    build_horizon_table, corridor_select_from_block, gather_horizon_block,
    solver_inputs_from_block)
from tests.test_torch_setup import jax_scenario, port_configs


@pytest.fixture(scope="module")
def sc():
    s = jax_scenario()
    model_cfg, mpc_cfg = port_configs()
    s.update(tpath=interop.path_data(s["path"]),
             tsegs=interop.segment_candidates(s["segs"]),
             tmodel=model_cfg, tcfg=mpc_cfg)
    s["table"] = build_horizon_table(s["tpath"], s["tsegs"], mpc_cfg)
    return s


ALL_WP = np.arange(200, dtype=np.int32)  # every base waypoint of the lap


def _jax_corridor(sc, wp):
    return jax.vmap(lambda w: jmpc_corridor(
        w, sc["path"], sc["grid"], sc["mpc_cfg"], sc["model_cfg"],
        sc["segs"]))(jnp.asarray(wp))


def test_horizon_table_matches_jax(sc):
    jt = np.asarray(jbuild_table(sc["path"], sc["segs"], sc["mpc_cfg"]))
    tt = sc["table"].numpy()
    assert tt.shape == jt.shape == (200, 30, 50)
    # positions, segments, valid flags and QP inputs are gathers (exact);
    # cos/sin columns may differ by float32 trig rounding
    np.testing.assert_allclose(tt, jt, atol=1e-6, rtol=0)
    trig = [2, 3, 5, 6]
    exact = [c for c in range(tt.shape[-1]) if c not in trig]
    np.testing.assert_array_equal(tt[..., exact], jt[..., exact])


def test_solver_inputs_from_block_bitwise(sc):
    tp = sc["tpath"]
    wp = torch.tensor([3, 77, 198, 0, 150], dtype=torch.int32)
    v, k, ds = solver_inputs_from_block(gather_horizon_block(sc["table"], wp), 8)
    idx = (wp.long()[:, None] + torch.arange(30)[None, :]) % tp.n_wp
    for got, want in ((v, tp.v_ref), (k, tp.kappa), (ds, tp.seg_dist)):
        np.testing.assert_array_equal(got.numpy(), want[idx].numpy())
        assert got.is_contiguous()


def test_k2_twin_matches_xla_corridor(sc):
    """Kernel K2's twin on the gathered blocks (the main path's corridor)
    vs the JAX package's corridor_from_segments, at every waypoint."""
    ref = _jax_corridor(sc, ALL_WP)
    blk = gather_horizon_block(sc["table"], torch.tensor(ALL_WP))
    out = corridor_select_from_block(blk, sc["tcfg"],
                                     sc["tmodel"].safety_margin)
    np.testing.assert_allclose(out.ub.numpy(), np.asarray(ref.ub), atol=2e-5)
    np.testing.assert_allclose(out.lb.numpy(), np.asarray(ref.lb), atol=2e-5)
    np.testing.assert_allclose(out.border_ub.numpy(),
                               np.asarray(ref.border_ub), atol=5e-5)
    np.testing.assert_allclose(out.border_lb.numpy(),
                               np.asarray(ref.border_lb), atol=5e-5)
    # the scan saw obstacle-split scanlines and narrowed corridors
    assert (sc["tsegs"].valid.sum(-1) >= 2).any()
    assert (out.ub.numpy() - out.lb.numpy()).min() < 0.1


def test_port_select_corridor_matches_xla(sc):
    """The port's atan2 selection (used by feasible_starts) vs JAX."""
    ref = _jax_corridor(sc, ALL_WP)
    out = mpc_corridor(torch.tensor(ALL_WP), sc["tpath"], sc["tcfg"],
                       sc["tmodel"], sc["tsegs"])
    for f in ("ub", "lb", "border_ub", "border_lb"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-6,
                                   err_msg=f)


def test_k2_twin_collapses_blocked_stages(sc):
    """No valid candidate at a stage -> the selected border is the
    waypoint itself; a corridor thinner than twice the margin collapses to
    ub = lb = 0 (the reference's blocked-path signal)."""
    blk = gather_horizon_block(sc["table"], torch.tensor([5, 60, 120]))
    blk = blk.clone()
    S = sc["tcfg"].max_segments
    va0 = 7 + 4 * S
    blk[:, 4:9, va0:va0 + S] = 0.0  # stages 4..8 blocked
    out = corridor_select_plain(blk, S, sc["tmodel"].safety_margin)
    assert (out.ub[:, 4:9] == 0).all() and (out.lb[:, 4:9] == 0).all()
    assert (out.ub[:, :4] > out.lb[:, :4]).all()


def _tpu_kernel_on_block(blk: np.ndarray, S: int, sm: float):
    """The JAX package's TPU kernel in interpret mode on a (B, N, F) block,
    after corridor_select_pallas_segs' lanes-last transposes."""
    from multi_purpose_mpc_tpu.ops.corridor_pallas import select_call_lanes_last

    lanes = 8
    B, N, _ = blk.shape
    pad = (-B) % lanes
    blk = np.concatenate([blk, np.repeat(blk[:1], pad, 0)])
    t2 = lambda c: jnp.asarray(blk[:, :, c].T)  # (Bp, N) -> (N, Bp)
    pts = lambda c0: jnp.asarray(
        blk[:, :, c0:c0 + 2 * S].reshape(B + pad, N, S, 2).transpose(1, 2, 3, 0))
    va0 = 7 + 4 * S
    valid = jnp.asarray(blk[:, :, va0:va0 + S].transpose(1, 2, 0))
    return select_call_lanes_last(
        pts(7), pts(7 + 2 * S), valid, *(t2(c) for c in range(7)), N=N, S=S,
        safety_margin=sm, out_batch=B, lanes=lanes, interpret=True)


@pytest.mark.parametrize("S", [1, 8, 13])
def test_k2_twin_edge_cases_match_tpu_kernel(S):
    """Exact score ties, zero-width segments (-0 and +0), empty stages, a
    lane blocked everywhere, a NaN lane and NaN points
    (tests/corridor_blocks.py) through the twin and the JAX TPU kernel in
    interpret mode: the first strict minimum, NaN never chosen, (x, y)
    kept where nothing is valid — the semantics kernel K2's reduction must
    keep.  Bars of this module's docstring, NaN equal to NaN."""
    from tests.corridor_blocks import SM_EXACT, edge_blocks

    blk = edge_blocks(12, 5, S, seed=S)
    out = corridor_select_plain(torch.from_numpy(blk), S, SM_EXACT)
    ref = _tpu_kernel_on_block(blk, S, SM_EXACT)
    for f, tol in (("ub", 2e-5), ("lb", 2e-5), ("border_ub", 5e-5),
                   ("border_lb", 5e-5)):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=tol,
                                   rtol=0, equal_nan=True, err_msg=f)
    # the tie lanes (kind 0) are exact: every stage bit for bit
    for f in ("ub", "lb"):
        np.testing.assert_array_equal(getattr(out, f).numpy()[0::6],
                                      np.asarray(getattr(ref, f))[0::6])
    assert np.isnan(out.ub.numpy()[4::6]).all()  # the NaN lanes
    assert (out.ub.numpy()[3::6] == 0).all()  # blocked everywhere: collapsed


def test_k2_dispatch_by_device(sc):
    """CPU tensors take the twin; the CUDA wrapper refuses CPU tensors."""
    from multi_purpose_mpc_tpu_torch.ops.corridor_cuda import corridor_select_cuda

    blk = gather_horizon_block(sc["table"], torch.tensor([1, 2]))
    a = corridor_select(blk, 8, 0.04)
    b = corridor_select_plain(blk, 8, 0.04)
    assert torch.equal(a.ub, b.ub) and torch.equal(a.border_lb, b.border_lb)
    with pytest.raises(ValueError):
        corridor_select_cuda(blk, 8, 0.04)


def test_table_non_circular_clamp(sc):
    """Non-circular paths bake the end-of-path clamp into the window."""
    path_cfg = dataclasses.replace(sc["path_cfg"], circular=False)
    jp = jbuild_path(sc["grid"], path_cfg)
    tp = interop.path_data(jp)
    n, S = tp.n_wp, 8
    segs = SegmentCandidates(torch.zeros(n, S, 2), torch.zeros(n, S, 2),
                             torch.zeros(n, S, dtype=torch.bool))
    table = build_horizon_table(tp, segs, sc["tcfg"])
    jt = jbuild_table(jp, JSegs(jnp.zeros((n, S, 2)), jnp.zeros((n, S, 2)),
                                jnp.zeros((n, S), bool)), sc["mpc_cfg"])
    np.testing.assert_allclose(table.numpy(), np.asarray(jt), atol=1e-6)
    last = table[n - 1]
    np.testing.assert_array_equal(last[:, 0].numpy(),
                                  np.full(30, float(tp.x[n - 1]), np.float32))
    idx = np.asarray(jgather(jp, n - 1, jnp.arange(30)))
    assert (idx == n - 1).all()
