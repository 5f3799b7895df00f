"""The benchmark's general part: find a cell's files by the names in
BENCHMARK.json, run its set-up, time its window, read its metrics, check its
output, and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

  configs/<config>.json       the configuration (BENCHMARK.json's `file`)
  traffic/<traffic>.json      the traffic mix: its `kind` names the general
                              driver (drivers/<kind>.py), the rest are its
                              parameters, and `limits` the output check's
  metrics/<metric>.py         a per-layer metric's reader: read(run) -> a
                              number, or None when there is nothing to read

A driver is a class `Driver(cell)` with `setup()`, `unit()` (one unit of
work in the window; returns its accounting), `end_to_end(window)`,
`attempted(window)` (the work items of the window: steps, docs, queries),
`check()` (after the window: the numbers compared, each with its limit)
and `control()` (the same numbers with the reference at float8 in the
program's place, for `calibrate.py` and the tests).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from . import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "opensearch_sparse_model_tuning_sample_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR
    seed: int = 0
    device: str = "cuda"
    chips: int = 1
    overrides: dict = field(default_factory=dict)

    def devices(self) -> List[torch.device]:
        if self.device == "cpu":
            return [torch.device("cpu")] * self.chips
        return [torch.device("cuda", i) for i in range(self.chips)]


def load_cell(name: str, bench_json: str = os.path.join(ROOT, "BENCHMARK.json"),
              bench_dir: str = BENCH_DIR, more: Optional[dict] = None) -> Cell:
    """The cell `name` of `bench_json`, whose lists `more` may extend with
    entries of its own (cells not in the file yet)."""
    with open(bench_json) as f:
        bench = json.load(f)
    for key, entries in (more or {}).items():
        bench[key] = bench[key] + entries
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in {bench_json}; have {sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    root = os.path.dirname(os.path.abspath(bench_json))
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                bench_dir=bench_dir, chips=int(w["chips"]))


def load_driver(cell: Cell):
    mod = importlib.import_module(f"lsr_bench.drivers.{cell.traffic['kind']}")
    return mod.Driver(cell)


def load_reader(bench_dir: str, metric: str) -> Callable:
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"lsr_bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Half:
    """The accounting of part of a window: its length and its units."""
    seconds: float = 0.0
    units: List[dict] = field(default_factory=list)

    def total(self, key: str) -> float:
        return float(sum(u.get(key, 0) for u in self.units))


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    driver: object
    first: Half                      # the unprofiled half of a traced run
    second: Half                     # the profiled half
    trace: Optional[trace_mod.Trace]


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _window(driver, seconds: float, devices) -> Half:
    half = Half()
    t0 = time.perf_counter()
    ends = []
    while time.perf_counter() - t0 < seconds:
        half.units.append(driver.unit())
        ends.append(time.perf_counter() - t0)
    _sync(devices)
    half.seconds = time.perf_counter() - t0
    quarters = [sum(1 for e in ends if q * seconds / 4 <= e < (q + 1) * seconds / 4)
                for q in range(4)]
    print(f"window: {len(ends)} units in {half.seconds:.3f} s; units by quarter {quarters}",
          file=sys.stderr)
    return half


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up, window, metrics and the output check; returns the result
    line's object (and the numbers compared under "checks")."""
    devices = cell.devices()
    driver = load_driver(cell)
    driver.setup()
    _sync(devices)
    setup_s = time.perf_counter() - t_start
    # what set-up made stays: the window's collections walk only what it makes
    gc.collect()
    gc.freeze()
    if trace:
        first = _window(driver, seconds / 2.0, devices)
        prof = trace_mod.Profiler([d.index for d in devices if d.type == "cuda"])
        driver.ranges.on = True
        prof.start() if devices[0].type == "cuda" else None
        second = _window(driver, seconds / 2.0, devices)
        driver.ranges.on = False
        tr = prof.stop() if devices[0].type == "cuda" else None
        if tr is not None:
            print(f"trace: {tr.n_ops} device operations, {tr.extra['ops_not_placed']} not "
                  f"placed in a host range; device seconds by range {tr.range_device_s}",
                  file=sys.stderr)
        run = Run(cell, driver, first, second, tr)
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(cell.bench_dir, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        whole = Half(first.seconds + second.seconds, first.units + second.units)
    else:
        whole = _window(driver, seconds, devices)
        e2e = driver.end_to_end(whole)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        tr = None
    device = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda"
              else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": max((torch.cuda.max_memory_allocated(d) for d in devices
                                        if d.type == "cuda"), default=0)}
    if tr is not None:
        device["busy_s"] = tr.busy_mean_s
        device["window_s"] = tr.window_s
    gc.unfreeze()
    attempted = driver.attempted(whole)
    checks = driver.check()
    del driver
    gc.collect()
    # every unit of the window ran to its end (an error ends the run); the
    # output check decides `correct`
    out = {"correct": all(c["value"] <= c["limit"] for c in checks), "attempted": attempted,
           "failed": 0, "metrics": metrics, "device": device}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
