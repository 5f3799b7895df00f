"""Where the host is while the card idles, by the program's spans.

The benchmark's own rule (`trace.read_events`) books a whole idle gap under
the innermost range open when the gap *began*. That is what the readers of
`<layer>_idle_share.*` sum (`layer_idle_share`): the idle time begun while
the host was inside the layer's spans. A gap that begins while the host
waits in one span and lasts through others is booked whole to the first:
in an ingest call the card goes idle while the host still waits inside
`encoder.copy_out`'s `.cpu()`, and stays idle while the host adds rows and
tokenizes the next chunk.

`split_gaps` splits each gap instead over the innermost span open at each
instant of it. Run on the card, this module profiles calls of a cell's unit
the way a traced run does and prints both readings:

    python3 -m lsr_bench.idle_split --workload distil-ingest --seed 3000000123 --calls 2

It is a tool for finding the cause, not a metric: the traced run keeps no
host ranges, so no reader can split a gap.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace as trace_mod


def layer_idle_share(run, layer: str) -> Optional[float]:
    """The card's idle time begun while the host was inside the spans
    `<layer>.*`, over (profiled window x cards), in percent; None without a
    trace or where it holds no such span (a program without them)."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.devices:
        return None
    pre = layer + "."
    if not any(k.startswith(pre) for k in list(tr.idle_by_range) + list(tr.range_ops)):
        return None
    idle = sum(v for k, v in tr.idle_by_range.items() if k.startswith(pre))
    return 100.0 * idle / (tr.window_s * len(tr.devices))


def gaps_of(busy: List[Tuple[int, int]], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The idle gaps of [t0, t1) between the union of the busy intervals."""
    _, merged = trace_mod.union_length(busy, t0, t1)
    gaps, prev = [], t0
    for s, e in merged + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def split_gaps(spans: List[Tuple[int, int, str]], busy: List[Tuple[int, int]], t0: int,
               t1: int) -> Dict[str, float]:
    """Seconds of idle time of [t0, t1) by the innermost span (start, end,
    name) open at each instant of it, on any thread ("outside_ranges" where
    none is); the busy intervals are one card's device operations."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = []
    for gs, ge in gaps_of(busy, t0, t1):
        lo, hi = bisect.bisect_right(bounds, gs), bisect.bisect_left(bounds, ge)
        pts = [gs] + bounds[lo:hi] + [ge]
        pieces += list(zip(pts, pts[1:]))
    out: Dict[str, float] = defaultdict(float)
    mids = [(a + b) / 2 for a, b in pieces]
    for (a, b), names in zip(pieces, trace_mod.open_ranges(spans, mids)):
        out[names[-1] if names else "outside_ranges"] += (b - a) / 1e9
    return dict(out)


def host_events(events):
    """(`lsr.*` host ranges as (start, end, name), device operations by card
    as {card: [(start, end)]}) of the profiler's events, as read_events
    takes them."""
    from torch.autograd import DeviceType

    spans, dev = [], defaultdict(list)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU and name.startswith(trace_mod.PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name[len(trace_mod.PREFIX):]))
        elif e.device_type() == DeviceType.CUDA and not name.startswith(trace_mod.PREFIX) \
                and not e.is_user_annotation():
            dev[e.device_index()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return spans, dev


def off_cost_ns(n: int = 1_000_000) -> Optional[dict]:
    """ns per span of the program with no profiler recording: the check
    alone, and a span with its `with`; None for a program without spans."""
    try:
        from opensearch_sparse_model_tuning_sample_torch.utils import tracing
    except ImportError:
        return None
    out = {}
    t = time.perf_counter()
    for _ in range(n):
        pass
    out["empty_loop_ns"] = (time.perf_counter() - t) / n * 1e9
    check = tracing._profiling
    t = time.perf_counter()
    for _ in range(n):
        check()
    out["check_ns"] = (time.perf_counter() - t) / n * 1e9
    span = tracing.span
    t = time.perf_counter()
    for _ in range(n):
        with span("data.tokenize"):
            pass
    out["span_with_ns"] = (time.perf_counter() - t) / n * 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="distil-ingest")
    ap.add_argument("--seed", type=int, default=3000000123)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out", default="", help="also write the JSON to this file")
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    import torch

    from . import harness

    res = {"off": off_cost_ns()}
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    cell.seed = args.seed
    devices = list(range(cell.chips))
    driver = harness.load_driver(cell)
    driver.setup()
    driver.unit()
    # as trace.Profiler, keeping the events for the split
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    driver.ranges.on = True
    prof.start()
    t0_ns, p0 = time.time_ns(), time.perf_counter()
    units = [driver.unit() for _ in range(args.calls)]
    for d in devices:
        torch.cuda.synchronize(d)
    t1_ns, window_s = time.time_ns(), time.perf_counter() - p0
    prof.stop()
    driver.ranges.on = False
    events = list(prof.profiler.kineto_results.events())
    tr = trace_mod.read_events(events, t0_ns, t1_ns, devices, window_s)
    spans, dev = host_events(events)
    split = defaultdict(float)
    for d in devices:
        for k, v in split_gaps(spans, dev.get(d, []), t0_ns, t1_ns).items():
            split[k] += v
    host_s, n = defaultdict(float), defaultdict(int)
    for s, e, name in spans:
        host_s[name] += (e - s) / 1e9
        n[name] += 1
    cards = len(devices)
    res.update({
        "workload": args.workload, "seed": args.seed, "calls": args.calls,
        "card": torch.cuda.get_device_name(0), "window_s": tr.window_s,
        "docs_per_s": sum(u.get("docs", 0) for u in units) / tr.window_s,
        "idle_share_pct": 100.0 * (1.0 - tr.busy_mean_s / tr.window_s),
        "device_ops_per_call": tr.n_ops / args.calls,
        "idle_begun_in_pct": {k: 100.0 * v / (tr.window_s * cards)
                              for k, v in sorted(tr.idle_by_range.items())},
        "idle_during_pct": {k: 100.0 * v / (tr.window_s * cards) for k, v in sorted(split.items())},
        "idle_during_s_per_call": {k: v / args.calls for k, v in sorted(split.items())},
        "host_s_per_call": {k: v / args.calls for k, v in sorted(host_s.items())},
        "spans_per_call": {k: v / args.calls for k, v in sorted(n.items())},
    })
    driver.release()
    driver.out.cleanup()
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
