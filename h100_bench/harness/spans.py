"""A traced window put down to the program's own spans.

While a profiler records, the program opens spans of its own
(`videosys_tpu_torch.utils.timing.span`, the names in `SPANS`, each
starting `videosys.`). This module reads a Chrome trace exported by
torch.profiler and puts down to the chain of program spans open on the
window's thread (their names, outermost first, joined by "/"; "" outside
them all): every idle gap of the card, at its midpoint; every host call
into the CUDA runtime that blocks until the card catches up (stream,
device and event synchronizes and the synchronous copies), around it; and
every device op, around the host op it is linked to, the ops with no such
link counted apart.

The window is the harness's `h100_bench.window` range where the trace has
one, else the stretch from the first `videosys.request` span's start to
the last one's end (a trace written by the program's `profile_trace`).
From the attribution come three readings: the card's idle milliseconds
while the host was inside `videosys.step` spans, a step; the blocking
calls issued there, a step; and the idle milliseconds outside every step
span, a video. Run as a script it prints them and a table by innermost
span:

    python3 h100_bench/harness/spans.py TRACE.json

`run.py` does not read it: its traced run keeps the reduction of
`trace.py` alone, not the raw trace these readings need.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):  # run as a script: `harness` is a package
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from harness import trace as tr  # noqa: E402

PROGRAM = "videosys."
REQUEST = PROGRAM + "request"
STEP = PROGRAM + "step"
# runtime calls that wait for the card (besides the synchronous copies)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


@dataclass
class Attribution:
    window_s: float
    busy_s: float
    # the program's spans in the window by name, and by chain of spans:
    # idle seconds, blocking runtime calls and device seconds
    span_counts: Dict[str, int] = field(default_factory=dict)
    idle_by_chain: Dict[str, float] = field(default_factory=dict)
    syncs_by_chain: Dict[str, int] = field(default_factory=dict)
    device_by_chain: Dict[str, float] = field(default_factory=dict)
    # device ops linked to no host op on the window's thread: count, seconds
    unlinked: Tuple[int, float] = (0, 0.0)


def blocking(name: str) -> bool:
    """A runtime call that returns only once the card has caught up."""
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def runtime_calls(trace: dict) -> List[tr.HostOp]:
    """The trace's blocking CUDA runtime calls, on every thread."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" \
                and blocking(e["name"]):
            start = float(e["ts"])
            out.append(tr.HostOp(0, e["name"], start,
                                 start + float(e.get("dur", 0)),
                                 e.get("tid", 0)))
    return out


def within(by_chain: Dict[str, float], name: str) -> float:
    """The sum over the chains that hold span `name`."""
    return sum(v for c, v in by_chain.items() if name in c.split("/"))


def _window(hosts: List[tr.HostOp]) -> tr.HostOp:
    windows = [h for h in hosts if h.name == tr.WINDOW]
    if len(windows) == 1:
        return windows[0]
    requests = [h for h in hosts if h.name == REQUEST]
    if windows or not requests or len({h.tid for h in requests}) != 1:
        raise RuntimeError(f"{len(windows)} window ranges and "
                           f"{len(requests)} request spans in the trace")
    return tr.HostOp(0, tr.WINDOW, min(h.start for h in requests),
                     max(h.end for h in requests), requests[0].tid)


def attribute(trace: dict) -> Attribution:
    hosts, devices = tr.events(trace)
    win = _window(hosts)
    main = sorted((h for h in hosts if h.tid == win.tid),
                  key=lambda h: (h.start, -h.end))
    in_win = [d for d in devices if d.end > win.start and d.start < win.end]
    busy = tr._union([(max(d.start, win.start), min(d.end, win.end))
                      for d in in_win])
    gaps, edge = [], win.start
    for s, e in busy + [(win.end, win.end)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    out = Attribution(window_s=(win.end - win.start) / 1e6,
                      busy_s=sum(e - s for s, e in busy) / 1e6)
    spans = [h for h in main if h.name.startswith(PROGRAM)
             and win.start <= h.start < win.end]
    for h in spans:
        out.span_counts[h.name] = out.span_counts.get(h.name, 0) + 1
    host = {h.ext: h for h in main if h.ext}
    linked = [d for d in in_win if d.link in host]
    calls = [h for h in runtime_calls(trace)
             if h.tid == win.tid and win.start <= h.start < win.end]
    chains = _chains(spans, [(s + e) / 2 for s, e in gaps]
                     + [(h.start + h.end) / 2 for h in calls]
                     + [(host[d.link].start + host[d.link].end) / 2
                        for d in linked])
    for (s, e), c in zip(gaps, chains):
        out.idle_by_chain[c] = out.idle_by_chain.get(c, 0.0) + (e - s) / 1e6
    chains = chains[len(gaps):]
    for c in chains[:len(calls)]:
        out.syncs_by_chain[c] = out.syncs_by_chain.get(c, 0) + 1
    for d, c in zip(linked, chains[len(calls):]):
        out.device_by_chain[c] = out.device_by_chain.get(c, 0.0) + (
            min(d.end, win.end) - max(d.start, win.start)) / 1e6
    rest = [d for d in in_win if d.link not in host]
    out.unlinked = (len(rest), sum(
        min(d.end, win.end) - max(d.start, win.start) for d in rest) / 1e6)
    return out


def _chains(spans: List[tr.HostOp], points: List[float]) -> List[str]:
    """The chain of `spans` (nested ranges of one thread, in start order)
    open at each point: their names, outermost first, joined by "/"; ""
    where none is."""
    out = [""] * len(points)
    stack: List[tr.HostOp] = []
    chain, j = "", 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        moved = False
        while j < len(spans) and spans[j].start <= t:
            while stack and stack[-1].end <= spans[j].start:
                stack.pop()
            stack.append(spans[j])
            j += 1
            moved = True
        while stack and stack[-1].end < t:
            stack.pop()
            moved = True
        if moved:
            chain = "/".join(s.name for s in stack)
        out[i] = chain
    return out


def step_idle_ms(a: Attribution) -> Optional[float]:
    """Idle milliseconds while the host was inside a step span, a step;
    None where the program opened no step span."""
    steps = a.span_counts.get(STEP, 0)
    if not steps:
        return None
    return 1e3 * within(a.idle_by_chain, STEP) / steps


def step_syncs(a: Attribution) -> Optional[float]:
    """Blocking runtime calls issued inside step spans, a step."""
    steps = a.span_counts.get(STEP, 0)
    if not steps:
        return None
    return within(a.syncs_by_chain, STEP) / steps


def phase_idle_ms(a: Attribution) -> Optional[float]:
    """Idle milliseconds while the host was in no step span (text, VAE,
    postprocess, between phases and requests), a video."""
    videos = a.span_counts.get(REQUEST, 0)
    if not a.span_counts.get(STEP) or not videos:
        return None
    idle = sum(a.idle_by_chain.values()) - within(a.idle_by_chain, STEP)
    return 1e3 * idle / videos


def table(a: Attribution) -> List[Tuple[str, int, float, float, int]]:
    """(innermost program span, spans of that name, device seconds, idle
    milliseconds, blocking calls), most device seconds first; "-" outside
    every span, "unlinked" the device ops linked to no host op."""
    rows: Dict[str, list] = {}
    for values, i, scale in ((a.device_by_chain, 2, 1.0),
                             (a.idle_by_chain, 3, 1e3),
                             (a.syncs_by_chain, 4, 1)):
        for chain, v in values.items():
            name = chain.rsplit("/", 1)[-1] or "-"
            row = rows.setdefault(name, [name, a.span_counts.get(name, 0),
                                         0.0, 0.0, 0])
            row[i] += v * scale
    out = sorted((tuple(v) for v in rows.values()), key=lambda v: -v[2])
    n, s = a.unlinked
    return out + [("unlinked", n, s, 0.0, 0)]


def report(a: Attribution) -> str:
    lines = [f"window_s {a.window_s:.6f} busy_s {a.busy_s:.6f}"]
    for name, f in (("step_idle_ms", step_idle_ms),
                    ("step_syncs", step_syncs),
                    ("phase_idle_ms", phase_idle_ms)):
        lines.append(f"{name} {f(a)}")
    lines.append("innermost span | spans | device s | idle ms | "
                 "blocking calls")
    lines += [f"{name} | {n} | {device_s:.6f} | {idle_ms:.3f} | {syncs}"
              for name, n, device_s, idle_ms, syncs in table(a)]
    return "\n".join(lines)


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print("usage: spans.py TRACE.json ...", file=sys.stderr)
        return 2
    for path in paths:
        with open(path) as f:
            print(f"{path}\n{report(attribute(json.load(f)))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
