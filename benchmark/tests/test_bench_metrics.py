"""Each per-layer reader's arithmetic on a small synthetic trace, window
and set-up, and the reduction of a profiler trace."""

import json
import os
import types

import pytest

from benchmark import drivers, run, trace
from benchmark.counts import k1, k6, k7

PEAKS = run.load_json(os.path.join(run.HERE, "peaks.json"))
SHAPES = dict(B=4096, N=30, K=128, iterations=30, rho_updates=6,
              polish_iters=10, stage_solver="auto", nb=91, H=500, W=500,
              WR=16)


def fake_trace(ops, busy=0.8, window=1.0):
    return trace.DeviceTrace(ops=ops, busy_s=busy, window_s=window,
                             idle_gaps=[["cudaGraphLaunch", 0.01]])


def ctx(ops=None, steps=100, shapes=SHAPES, window=None, capture=None,
        k7_in_range=None):
    ops = ops if ops is not None else {
        "void admm_fused_kernel<false>(Params)": [100, 0.55],
        "corridor_select_kernel": [100, 0.002],
        "scan_cells_kernel": [100, 0.07],
        "writeback_extract_packed_kernel": [100, 0.02],
        "admm_structured_kernel": [0, 0.0],
        "void at::native::elementwise_kernel<...>": [5000, 0.03],
        "ncclDevKernel_AllReduce_Max_u8": [100, 0.01],
        "Memcpy DtoD (Device -> Device)": [200, 0.005]}
    window = window or drivers.Window(10.0, 20, 4096000, 990, 1000, 4, [],
                                      [0.003, 0.004, 0.005])
    return run.Context(trace=fake_trace(ops), steps=steps,
                       window=window, capture=[(0.5, 0.02)] if capture is None else capture,
                       shapes=shapes, peaks=PEAKS, kernels=run.hand_kernels(),
                       k7_in_range=k7_in_range)


def read(name, c):
    return run.reader(name)(c)


def test_idle_share():
    assert read("device_idle_pct.fleet", ctx()) == pytest.approx(20.0)
    assert read("device_idle_pct.api", ctx()) == pytest.approx(20.0)


def test_k1_time_and_roofline():
    c = ctx()
    assert read("k1_ms_per_step", c) == pytest.approx(5.5)
    bound = max(k1.ops(4096, 30, 30, 6, 10) / PEAKS["fp32_flop_per_s"],
                k1.nbytes(4096, 30) / PEAKS["hbm_bytes_per_s"])
    assert read("k1_roofline_pct", c) == pytest.approx(100 * bound / 0.0055)
    assert read("k1_roofline_pct", ctx(shapes={**SHAPES,
                                               "stage_solver": "cr"})) is None
    none = ctx(ops={"corridor_select_kernel": [1, 1e-5]})
    assert read("k1_ms_per_step", none) is None
    assert read("k1_roofline_pct", none) is None


def test_glue_leaves_out_hand_kernels_nccl_and_copies():
    assert read("torch_ops_ms_per_step", ctx()) == pytest.approx(0.3)


def test_solver_fail_share():
    assert read("solver_fail_pct", ctx()) == pytest.approx(0.4)
    idle = drivers.Window(10.0, 0, 0, 0, 0, 0, [], [])
    assert read("solver_fail_pct", ctx(window=idle)) is None


def test_k6_and_k7_rooflines():
    c = ctx(k7_in_range=(10 ** 9, 409600))
    b6 = max(k6.ops(4096, 16, 500, 91) / PEAKS["fp32_flop_per_s"],
             k6.nbytes(4096, 16, 500, 91, 30, 128) / PEAKS["hbm_bytes_per_s"])
    assert read("k6_roofline_pct", c) == pytest.approx(100 * b6 / 2e-4)
    b7 = max(k7.ops(10 ** 9, 91) / PEAKS["fp32_flop_per_s"],
             k7.nbytes(10 ** 9, 409600, 91) / PEAKS["hbm_bytes_per_s"])
    assert read("k7_roofline_pct", c) == pytest.approx(100 * b7 / 0.07)
    assert read("k7_roofline_pct", ctx()) is None
    assert read("k6_roofline_pct", ctx(shapes={k: v for k, v in SHAPES.items()
                                               if k != "WR"})) is None


def test_api_readers():
    c = ctx(ops={"admm_structured_kernel": [200, 0.34]}, steps=200)
    assert read("k3_ms_per_cycle", c) == pytest.approx(1.7)
    assert read("get_control_ms_p50", c) == pytest.approx(4.0)
    assert read("k1_ms_per_step", c) is None
    assert read("k3_ms_per_cycle", ctx()) is None


def test_capture():
    assert read("capture_s", ctx(capture=[(0.5, 0.02), (0.1, 0.03)])) == \
        pytest.approx(0.65)
    assert read("capture_s", ctx(capture=[(0, 0)][:0])) is None


def _event(name, dev, a, b):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_reduce_busy_union_gaps_and_top():
    ev = [_event("k1", True, 0, 100), _event("k2", True, 50, 150),
          _event("k1", True, 300, 400), _event("k3", True, 1000, 1010),
          _event("cudaGraphLaunch", False, 140, 320),
          _event("aten::clone", False, 420, 990),
          _event("step", False, 0, 2000)]
    t = trace.reduce(ev, window_s=0.002)
    assert t.busy_s == pytest.approx(260e-6)
    assert t.ops["k1"] == [2, pytest.approx(200e-6)]
    assert t.top(2) == [["k1", pytest.approx(200e-6)],
                        ["k2", pytest.approx(100e-6)]]
    assert t.idle_gaps == [["aten::clone", pytest.approx(600e-6)],
                           ["cudaGraphLaunch", pytest.approx(150e-6)]]


def test_every_manifest_reader_returns_a_number_or_none():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for m in manifest["per_layer"]:
        for c in (ctx(), ctx(k7_in_range=(10, 5)),
                  ctx(ops={"admm_structured_kernel": [200, 0.34]})):
            v = read(m["name"], c)
            assert v is None or isinstance(v, float)
