"""The device trace of a window: torch.profiler (CUPTI) over the window, read
back as the card's busy time, operations, and the benchmark's own host
ranges.

Busy time is the union of the device operations' intervals, card by card,
so operations that overlap on streams or cards count once (summing each
operation's own device time counts overlap twice). An operation belongs to
a host range when the host operation that launched it (the profiler's
link from a device event to the host event that queued it) started inside
that range on the same thread, so a kernel is attributed by where it was
called from and not by its name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

PREFIX = "lsr."


class Ranges:
    """The benchmark's host ranges (`lsr.<name>`): profiler annotations
    while a trace is being taken, nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


def union_length(iv: List[Tuple[int, int]], lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
    """Length of the union of intervals clipped to [lo, hi], and the merged
    intervals in order."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


@dataclass
class Trace:
    window_s: float
    devices: List[int]
    busy_s: Dict[int, float]                       # per card
    n_ops: int
    ops_by_name: Dict[str, float]                  # device seconds by operation name
    range_device_s: Dict[str, float]               # union of device time launched inside each range
    range_ops: Dict[str, int]
    idle_by_range: Dict[str, float]                # idle seconds by the host range open then
    extra: dict = field(default_factory=dict)

    @property
    def busy_mean_s(self) -> float:
        return sum(self.busy_s.values()) / max(len(self.devices), 1)

    def breakdown(self) -> dict:
        top = sorted(self.ops_by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def open_ranges(ranges: List[Tuple[int, int, str]], times: List[int]) -> List[List[str]]:
    """For each of `times` (in any order), the names of the ranges
    [(start, end, name)] open then, outermost first: one sweep in time
    order, so a range holding many nested ones is still found."""
    ranges = sorted(ranges)
    out: List[List[str]] = [[] for _ in times]
    active: List[Tuple[int, int, str]] = []
    i = 0
    for t, k in sorted((t, k) for k, t in enumerate(times)):
        while i < len(ranges) and ranges[i][0] <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= t]
        out[k] = [r[2] for r in active]
    return out


class Profiler:
    """torch.profiler over [start(), stop()); stop() returns the Trace."""

    def __init__(self, devices: List[int]):
        self.devices = devices
        self.prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.time_ns()
        self.p0 = time.perf_counter()

    def stop(self) -> Trace:
        for d in self.devices:
            torch.cuda.synchronize(d)
        t1 = time.time_ns()
        window_s = time.perf_counter() - self.p0
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        trace = read_events(events, self.t0, t1, self.devices, window_s)
        self.prof = None
        return trace


def read_events(events, t0: int, t1: int, devices: List[int], window_s: float) -> Trace:
    from torch.autograd import DeviceType

    host: Dict[int, Tuple[int, int]] = {}     # host operations by their id
    launches: Dict[int, Tuple[int, int]] = {}  # CUDA API calls by their CUPTI correlation
    ranges = []
    dev = []
    for e in events:
        dt = e.device_type()
        name = e.name()
        if dt == DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name[len(PREFIX):]))
            if name.startswith("cu"):
                launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            else:
                host[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif dt == DeviceType.CUDA:
            if name.startswith(PREFIX) or e.is_user_annotation():
                continue
            s = e.start_ns()
            dev.append((e.device_index(), s, s + e.duration_ns(), name,
                        (e.correlation_id(), e.linked_correlation_id())))
    by_tid = defaultdict(list)
    for rs, re_, tid, name in ranges:
        by_tid[tid].append((rs, re_, name))
    per_dev = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    in_range = defaultdict(list)
    range_ops: Dict[str, int] = defaultdict(int)
    n_ops = unplaced = 0
    placed = defaultdict(list)  # thread -> [(launch time, (start, end))]
    for d, s, e, name, (corr, link) in dev:
        if e <= t0 or s >= t1:
            continue
        n_ops += 1
        per_dev[d].append((s, e))
        by_name[name[:96]] += (min(e, t1) - max(s, t0)) / 1e9
        # the API call that launched it, else the host operation it is linked to
        launch = launches.get(corr) or host.get(link)
        if launch is None:
            unplaced += 1
        else:
            placed[launch[1]].append((launch[0], (s, e)))
    for tid, items in placed.items():
        for (_, iv), names in zip(items, open_ranges(by_tid.get(tid, []), [t for t, _ in items])):
            for r in names:
                in_range[r].append(iv)
                range_ops[r] += 1
    busy = {}
    idle: Dict[str, float] = defaultdict(float)
    every = [(rs, re_, name) for rs, re_, _, name in ranges]
    for d in devices:
        length, merged = union_length(per_dev.get(d, []), t0, t1)
        busy[d] = length / 1e9
        gaps, prev = [], t0
        for s, e in merged + [(t1, t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        # a gap goes to the innermost range open when it began, on any thread
        for (gs, ge), names in zip(gaps, open_ranges(every, [g[0] for g in gaps])):
            idle[names[-1] if names else "outside_ranges"] += (ge - gs) / 1e9
    range_s = {r: union_length(iv, t0, t1)[0] / 1e9 for r, iv in in_range.items()}
    return Trace(window_s=window_s, devices=list(devices), busy_s=busy, n_ops=n_ops,
                 ops_by_name=dict(by_name), range_device_s=range_s, range_ops=dict(range_ops),
                 idle_by_range=dict(idle),
                 extra={"ops_not_placed": unplaced})
