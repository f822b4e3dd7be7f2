"""The trace's reduction on a hand-made Chrome trace: the window, the busy
union, the idle gaps and their labels, and each attention call's device
seconds between its two marker fills on its stream, the fills found by
their kernel's name, or by their host link where the name does not
serve."""

import pytest

from harness import trace as tr


def host(name, ts, dur, ext, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"External id": ext}}


def dev(name, ts, dur, ext, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": stream, "args": {"External id": ext, "stream": stream}}


FILL = "void at::native::vectorized_elementwise_kernel<4, " \
    f"at::native::{tr.MARK_KERNEL}, std::array<char*, 1ul> >"


def make_trace(named: bool = False, linked: bool = True) -> dict:
    """One attention call; its fills' kernels named as the card names
    them (`named`), and linked to their host ops (`linked`)."""
    fill = FILL if named else "fill"
    return {"traceEvents": [
        host(tr.WINDOW, 0, 1000, 1, cat="user_annotation"),
        host("aten::mm", 10, 20, 2),
        dev("gemm", 50, 100, 2),
        host(tr.BEGIN + "0", 200, 10, 3, cat="user_annotation"),
        host("aten::fill_", 201, 5, 4),
        dev(fill, 220, 2, 4 if linked else 0),
        # the attention kernel, launched with no link to a host op; its
        # recorded start a microsecond before the fill's recorded end
        dev("flash_fwd_wide", 221, 304, 0),
        dev("other_stream", 230, 50, 0, stream=9),
        host(tr.END + "0", 260, 10, 5, cat="user_annotation"),
        host("aten::fill_", 261, 5, 6),
        dev(fill, 530, 2, 6 if linked else 0),
        host("aten::copy_", 600, 300, 8),
        dev("copy", 900, 40, 8),
    ]}




@pytest.mark.parametrize("named,linked", [(False, True), (True, False),
                                          (True, True)])
def test_reduction_of_a_hand_made_trace(named, linked):
    r = tr.reduce(*tr.events(make_trace(named, linked)))
    assert r.markers.get("by_name", 0) == (1 if named else 0)
    assert r.window_s == pytest.approx(1000e-6)
    # busy: [50, 150] [220, 525] (230-280 inside) [530, 532] [900, 940]
    assert r.busy_s == pytest.approx((100 + 305 + 2 + 40) * 1e-6)
    assert r.attn_device_s == {0: pytest.approx(304e-6)}
    assert r.device_ops[0] == ("flash_fwd_wide", pytest.approx(304e-6))
    gaps = dict((round(s * 1e6), n) for n, s in r.idle_gaps)
    fill = FILL if named else "fill"
    assert dict(r.device_ops)[fill] == pytest.approx(4e-6)
    assert gaps[368] == "aten::copy_"  # 532 .. 900, the copy's host op
    assert gaps[50] == "aten::mm"  # 0 .. 50, at 25 the mm runs
    assert gaps[60] == tr.WINDOW  # 940 .. 1000
    assert len(r.idle_gaps) == 5


@pytest.mark.parametrize("named", [False, True])
def test_a_call_with_no_kernel_reads_zero(named):
    events = [e for e in make_trace(named)["traceEvents"]
              if e["name"] != "flash_fwd_wide"]
    r = tr.reduce(*tr.events({"traceEvents": events}))
    assert r.attn_device_s[0] == 0.0
    assert r.markers["empty"] == 1


def test_unlinked_fills_of_another_name_leave_the_call_unpaired():
    events = make_trace(named=False, linked=False)["traceEvents"]
    r = tr.reduce(*tr.events({"traceEvents": events}))
    assert r.attn_device_s == {0: 0.0} and r.markers["unpaired"] == 1
