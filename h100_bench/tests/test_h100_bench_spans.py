"""A trace put down to the program's spans (`harness/spans.py`) on a
hand-made Chrome trace: idle gaps by the chain of spans at their midpoint,
blocking runtime calls of the window's thread by the chain around them,
device ops by the chain around their host op and the unlinked ones apart;
the three readings and the table; a window taken from the request spans
where the trace has no harness window; the benchmark's own reduction of
the same trace unchanged by the runtime calls; and a trace without
program spans (the program before it opened any) reads nothing and raises
nothing."""

import json
import subprocess
import sys

import pytest

from harness import spans as sp
from harness import trace as tr
from videosys_tpu_torch.utils import timing

from test_h100_bench_trace import dev, host, make_trace

REQ = "videosys.request"
TEXT = "videosys.text"
DENOISE = "videosys.denoise"
STEP = "videosys.step"
ATTN = "videosys.attn"
POST = "videosys.postprocess"


def span(name, ts, dur, ext):
    return host(name, ts, dur, ext, cat="user_annotation")


def runtime(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "tid": tid, "args": {"External id": 0}}


def memcpy(ts, dur, ext):
    return dict(dev("Memcpy DtoH", ts, dur, ext), cat="gpu_memcpy")


def spans_trace(window: bool = True) -> dict:
    """One request of two steps on the window's thread (tid 1); busy
    [50, 90] [160, 250] [330, 380] [450, 650] [655, 695] of [0, 1000]."""
    events = [
        span(REQ, 0, 900, 100),
        span(TEXT, 10, 90, 101),
        host("aten::mm", 20, 20, 2),
        dev("gemm", 50, 40, 2),
        span(DENOISE, 100, 700, 102),
        span(STEP, 110, 290, 103),
        span(ATTN, 120, 180, 104),
        host("aten::copy_", 150, 120, 3),
        runtime("cudaStreamSynchronize", 200, 60),
        memcpy(160, 90, 3),
        host("aten::add", 310, 10, 4),
        dev("add", 330, 50, 4),
        span(STEP, 420, 280, 105),
        host("aten::mul", 430, 10, 5),
        dev("mul", 450, 200, 5),
        # a kernel linked to no host op
        dev("flash", 655, 40, 0),
        runtime("cudaDeviceSynchronize", 660, 30),
        span(POST, 810, 80, 106),
        runtime("cudaMemcpy", 820, 30),
        # not blocking, and blocking on another thread: neither counts
        runtime("cudaMemcpyAsync", 855, 1),
        runtime("cudaLaunchKernel", 856, 1),
        runtime("cudaStreamSynchronize", 500, 10, tid=2),
    ]
    if window:
        events.insert(0, span(tr.WINDOW, 0, 1000, 1))
    return {"traceEvents": events}


def chain(*names):
    return "/".join(names)


def test_attribution_by_chain():
    a = sp.attribute(spans_trace())
    us = pytest.approx
    assert a.window_s == us(1000e-6) and a.busy_s == us(420e-6)
    assert a.span_counts == {REQ: 1, TEXT: 1, DENOISE: 1, STEP: 2, ATTN: 1,
                             POST: 1}
    # gaps: [0, 50] at 25 (text), [90, 160] at 125 and [250, 330] at 290
    # (attn), [380, 450] at 415 (between steps), [650, 655] (step 2),
    # [695, 1000] at 847.5 (postprocess)
    assert a.idle_by_chain == {
        chain(REQ, TEXT): us(50e-6),
        chain(REQ, DENOISE, STEP, ATTN): us(150e-6),
        chain(REQ, DENOISE): us(70e-6),
        chain(REQ, DENOISE, STEP): us(5e-6),
        chain(REQ, POST): us(305e-6)}
    assert sum(a.idle_by_chain.values()) == us(a.window_s - a.busy_s)
    assert a.syncs_by_chain == {chain(REQ, DENOISE, STEP, ATTN): 1,
                                chain(REQ, DENOISE, STEP): 1,
                                chain(REQ, POST): 1}
    assert a.device_by_chain == {chain(REQ, TEXT): us(40e-6),
                                 chain(REQ, DENOISE, STEP, ATTN): us(90e-6),
                                 chain(REQ, DENOISE, STEP): us(250e-6)}
    assert a.unlinked == (1, us(40e-6))


def test_readings_on_the_hand_made_trace():
    a = sp.attribute(spans_trace())
    # (150 + 5) us of idle inside the two steps; 580 - 155 outside, a video
    assert sp.step_idle_ms(a) == pytest.approx(0.0775)
    assert sp.step_syncs(a) == pytest.approx(1.0)
    assert sp.phase_idle_ms(a) == pytest.approx(0.425)


def test_table_by_innermost_span():
    rows = {r[0]: r[1:] for r in sp.table(sp.attribute(spans_trace()))}
    assert rows[STEP] == (2, pytest.approx(250e-6), pytest.approx(5e-3), 1)
    assert rows[ATTN] == (1, pytest.approx(90e-6), pytest.approx(150e-3), 1)
    assert rows[DENOISE] == (1, 0.0, pytest.approx(70e-3), 0)
    assert rows[POST] == (1, 0.0, pytest.approx(305e-3), 1)
    assert rows["unlinked"] == (1, pytest.approx(40e-6), 0.0, 0)


def test_window_from_the_request_spans(tmp_path):
    """A trace of the program's `profile_trace` has no harness window:
    the request spans' stretch [0, 900] is the window, so the last 100 us
    of idle fall out; the script prints the same readings."""
    a = sp.attribute(spans_trace(window=False))
    assert a.window_s == pytest.approx(900e-6)
    assert sp.step_idle_ms(a) == pytest.approx(0.0775)
    assert sp.phase_idle_ms(a) == pytest.approx(0.325)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(spans_trace(window=False)))
    out = subprocess.run([sys.executable, sp.__file__, str(path)],
                         capture_output=True, text=True, check=True).stdout
    assert "step_syncs 1.0" in out and f"{STEP} | 2 |" in out
    with pytest.raises(RuntimeError, match="0 window ranges"):
        sp.attribute({"traceEvents": [host("aten::mm", 0, 1, 1)]})


@pytest.mark.parametrize("named,linked", [(False, True), (True, True)])
def test_a_trace_without_program_spans(named, linked):
    """Blocking runtime calls on the window's thread, one inside an idle
    gap, change nothing the benchmark's reduction reads; with no program
    span everything is put down to "" and the readings find nothing."""
    events = make_trace(named, linked)["traceEvents"]
    before = tr.reduce(*tr.events({"traceEvents": events}))
    trace = {"traceEvents": events + [
        runtime("cudaStreamSynchronize", 560, 300),
        runtime("cudaMemcpy", 945, 10)]}
    assert tr.reduce(*tr.events(trace)) == before
    a = sp.attribute(trace)
    assert a.busy_s == pytest.approx(before.busy_s)
    assert a.span_counts == {}
    assert a.syncs_by_chain == {"": 2}
    assert set(a.idle_by_chain) == set(a.device_by_chain) == {""}
    for f in (sp.step_idle_ms, sp.step_syncs, sp.phase_idle_ms):
        assert f(a) is None
    assert [r[0] for r in sp.table(a)] == ["-", "unlinked"]


def test_span_names_are_the_programs():
    assert {sp.REQUEST, sp.STEP} <= set(timing.SPANS)
    assert all(n.startswith(sp.PROGRAM) for n in timing.SPANS)
