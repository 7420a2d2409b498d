"""BENCHMARK.json against the benchmark's contract, and every entry's file
found by its name."""

import json
import os
import re

import pytest

from benchmark import drivers, run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_budget_fits_the_full_check(manifest):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compiling a
    cell, 1200 s spare: within 43200 s with the full 24 cells."""
    cells = 24
    need = (2 + 14 * cells) * (manifest["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [n for g, n in names if g == group]
        assert len(seen) == len(set(seen))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs_found_and_unreduced(manifest):
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(ROOT, cfg["map"]["file"]))
        assert not any(WIDTH.search(k) for k in c["reduced"])
        used = [w for w in manifest["workloads"] if w["config"] == c["name"]]
        assert used, f"configuration {c['name']} has no cell"


def test_cells_found_by_name(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    fours = 0
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        fours += w["chips"] == 4
        with open(os.path.join(run.HERE, "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert traffic["name"] == w["traffic"]
        assert callable(drivers.kind(traffic["kind"]).Driver)
        with open(os.path.join(run.HERE, "limits", f"{w['name']}.json")) as f:
            assert json.load(f)
    assert fours <= max(1, len(manifest["workloads"]) // 4)


def test_metrics_found_and_reported(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(run.reader(m["name"]))
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"
    for w in manifest["workloads"]:
        reported = {m["name"] for m in run.for_cell(manifest["end_to_end"],
                                                    w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = run.for_cell(manifest["per_layer"], w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in reported, (w["name"], m["name"])


def test_kernel_symbols_found():
    kernels = run.hand_kernels()
    assert {"K1", "K3", "K6", "K7"} <= set(kernels)
    src = os.path.join(ROOT, "multi_purpose_mpc_tpu_torch", "csrc")
    text = "".join(open(os.path.join(src, f)).read() for f in os.listdir(src))
    for sym in kernels.values():
        assert sym in text
