"""The benchmark's cells driven on the CPU at a size a test run holds: the
port's plain versions in place of its kernels, the same traffic kinds and
the same check."""

import contextlib
import os

from benchmark import checks, drivers, run, scenario

SEED = 2147483659  # past 32 signed bits, as the checks' seeds are
SMALL = {"static_fleet": dict(batch=8, steps=4, pool=1, start_lanes=8,
                              check_lanes=3),
         "lidar_discovery": dict(batch=8, steps=4, pool=1, start_lanes=8,
                                 check_lanes=3),
         "api_loop": dict(warm_up_cycles=1, check_cycles=4),
         "shared_map_x4": dict(batch=8, steps=4, pool=1, start_lanes=8,
                               check_lanes=3)}
CELLS = {"sim_track.static_fleet": ("sim_track", "static_fleet"),
         "sim_track.lidar_discovery": ("sim_track", "lidar_discovery"),
         "real_track.api_loop": ("real_track", "api_loop"),
         "sim_track.shared_map_x4": ("sim_track", "shared_map_x4")}


def load(cell):
    conf, traffic = CELLS[cell]
    cfg = run.load_json(os.path.join(run.HERE, "configs", f"{conf}.json"))
    tr = run.load_json(os.path.join(run.HERE, "traffic", f"{traffic}.json"))
    tr.update(SMALL[traffic])
    return cfg, tr


def drive(cell, seed=SEED, cycles=4, **traffic):
    """``(driver, cfg, cell)`` of ``cell`` after its warm-up and one call
    (or ``cycles`` API cycles) of the window; ``traffic`` overrides the
    traffic file's parameters."""
    cfg, tr = load(cell)
    tr.update(traffic)
    d = drivers.make(scenario.configs(cfg, run.ROOT), tr, seed, "cpu")
    d.warm_up()
    if hasattr(d, "cycle"):
        for _ in range(cycles):
            d.cycle(True)
    else:
        d.call()
    return d, cfg, cell


def check(d, cfg, cell, seed=SEED, low=False):
    found = checks.check(d, cfg, run.ROOT, seed, cell, low=low)
    return found, bool(found) and all(v <= lim for v, lim in found.values())


@contextlib.contextmanager
def patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn(old))
    try:
        yield
    finally:
        setattr(obj, name, old)
