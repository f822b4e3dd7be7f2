"""The traced window: torch.profiler over the card, and its reduction.

The harness marks the window with a range of its own, and brackets each
attention call, from outside the program, with two one-element int16
fills on the call's stream, each inside a range of its own
(`attention.py`). The reduction reads the profiler's exported trace: the
busy seconds (the union of device ops in the window), the window's
length, each attention call's device seconds (the device ops its stream
ran between its two fills, whatever API launched them), the device ops
that took most time, and the longest idle gaps labelled by the innermost
host op running then.

A fill's device op is found by its kernel's name (the program fills no
int16 tensor): the window's marker fills, in the order the card ran
them, are the calls' begin and end fills in call order, as long as their
count is twice the calls'. Only where it is not does the reduction fall
back on the profiler's link from a device op to the host op that launched
it (its "External id"), which CUPTI leaves out for some launches.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "h100_bench.window"
BEGIN = "h100_bench.attn_begin#"
END = "h100_bench.attn_end#"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernel of a marker fill (`attention.py` fills an int16 tensor)
MARK_KERNEL = "FillFunctor<short>"


@dataclass
class HostOp:
    ext: int  # the profiler's external id, which device ops link to
    name: str
    start: float  # microseconds
    end: float
    tid: int


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    link: int
    stream: int


@dataclass
class Reduction:
    busy_s: float
    window_s: float
    attn_device_s: Dict[int, float] = field(default_factory=dict)
    # how the markers were found, for the run's log
    markers: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def events(trace: dict) -> Tuple[List[HostOp], List[DeviceOp]]:
    """Host and device ops of a Chrome trace exported by torch.profiler."""
    hosts, devices = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        start = float(e["ts"])
        end = start + float(e.get("dur", 0))
        ext = int(args.get("External id", 0) or 0)
        if cat in DEVICE_KINDS:
            devices.append(DeviceOp(e["name"], start, end, ext,
                                    int(args.get("stream", e.get("tid", 0)))))
        elif cat in ("cpu_op", "user_annotation"):
            hosts.append(HostOp(ext, e["name"], start, end, e.get("tid", 0)))
    return hosts, devices


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _marker_ops(main: List[HostOp], by_link: Dict[int, List[DeviceOp]],
                prefix: str) -> Dict[int, DeviceOp]:
    """Call index -> the device op launched inside each `prefix` range."""
    ranges = [h for h in main if h.name.startswith(prefix)]
    starts = [h.start for h in main]
    out = {}
    for r in ranges:
        i = int(r.name[len(prefix):])
        lo = bisect.bisect_left(starts, r.start)
        hi = bisect.bisect_right(starts, r.end)
        for h in main[lo:hi]:
            if h.end <= r.end and by_link.get(h.ext):
                out[i] = by_link[h.ext][0]
                break
    return out


def _markers(main: List[HostOp], in_win: List[DeviceOp],
             by_link: Dict[int, List[DeviceOp]]):
    """(begins, ends, counts): call index -> its begin and end fill's
    device op, by the fills' kernel name where their count fits, else by
    the host link."""
    calls = sorted(int(h.name[len(BEGIN):]) for h in main
                   if h.name.startswith(BEGIN))
    fills = [d for d in in_win if MARK_KERNEL in d.name]
    counts = dict(calls=len(calls), fills=len(fills))
    if len(fills) == 2 * len(calls):
        counts["by_name"] = len(calls)
        return ({i: fills[2 * n] for n, i in enumerate(calls)},
                {i: fills[2 * n + 1] for n, i in enumerate(calls)}, counts)
    begins = _marker_ops(main, by_link, BEGIN)
    ends = _marker_ops(main, by_link, END)
    counts.update(by_link_begin=len(begins), by_link_end=len(ends))
    return begins, ends, counts


def reduce(hosts: List[HostOp], devices: List[DeviceOp]) -> Reduction:
    windows = [h for h in hosts if h.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} window ranges in the trace")
    win = windows[0]
    main = sorted((h for h in hosts if h.tid == win.tid),
                  key=lambda h: (h.start, -h.end))
    in_win = sorted((d for d in devices
                     if d.end > win.start and d.start < win.end),
                    key=lambda d: d.start)
    by_link: Dict[int, List[DeviceOp]] = defaultdict(list)
    per_stream: Dict[int, List[DeviceOp]] = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    for d in in_win:
        if d.link:
            by_link[d.link].append(d)
        per_stream[d.stream].append(d)
        by_name[d.name] += d.end - d.start
    begins, ends, counts = _markers(main, in_win, by_link)
    # a stream runs its ops in order: a call owns what its stream ran
    # between its two fills, found by position (the recorded times of
    # adjacent ops may overlap by a microsecond)
    position = {id(d): i for ops in per_stream.values()
                for i, d in enumerate(ops)}
    attn_s: Dict[int, float] = {}
    calls = [int(h.name[len(BEGIN):]) for h in main
             if h.name.startswith(BEGIN)]
    for i in sorted(set(calls) | set(begins) | set(ends)):
        b, e = begins.get(i), ends.get(i)
        if b is None or e is None or b.stream != e.stream:
            attn_s[i] = 0.0
            counts["unpaired"] = counts.get("unpaired", 0) + 1
            continue
        ops = per_stream[b.stream][position[id(b)] + 1:position[id(e)]]
        if not ops:
            counts["empty"] = counts.get("empty", 0) + 1
        attn_s[i] = sum(x - s for s, x in _union(
            [(d.start, d.end) for d in ops])) / 1e6
    spans = _union([(max(d.start, win.start), min(d.end, win.end))
                    for d in in_win])
    busy = sum(e - s for s, e in spans)
    gaps, edge = [], win.start
    for s, e in spans + [(win.end, win.end)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host_starts = [h.start for h in main]
    idle = [(_label(main, host_starts, (s + e) / 2), (e - s) / 1e6)
            for s, e in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Reduction(busy_s=busy / 1e6, window_s=(win.end - win.start) / 1e6,
                     attn_device_s=attn_s, markers=counts,
                     device_ops=[(n, s / 1e6) for n, s in top],
                     idle_gaps=idle)


def _label(main: List[HostOp], starts: List[float], t: float) -> str:
    """The innermost host op on the window's thread running at `t`."""
    best: Optional[HostOp] = None
    for h in main[:bisect.bisect_right(starts, t)]:
        if h.end >= t and (best is None or h.start >= best.start):
            best = h
    return best.name if best is not None else "host"


def read(prof, scratch: str) -> Reduction:
    """Reduce a finished profiler's trace, exported under the directory
    `scratch` and removed once read."""
    path = os.path.join(scratch, f"h100_bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return reduce(*events(trace))


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
