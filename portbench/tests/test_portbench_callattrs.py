"""The readers of the device calls' dispatch and reads and of the
collector's pauses, on hand-made windows: the calls outside the profiled
slice only (the sync counter over every tick, as the row counter),
a tick's parts summing to the tick, the pauses over the
window less the slice, and silence where the program records none."""

import pytest

from portbench import devtrace, harness, traffic
from test_portbench_metrics import Span, reader, window


def _tick(t0, t1, dispatch_s, rows):
    return [Span("head", "decode_tick", t0, t1, rid=r,
                 attrs={"rows": rows, "dispatch_s": dispatch_s,
                        "syncs": rows}) for r in range(rows)]


def _traced(spans, slice_sids, slice_s):
    """A window whose profiled slice holds the spans with sids in
    ``slice_sids`` and lasted ``slice_s`` of its 10 s."""
    recs = {r: harness.Rec(traffic.Spec(r, "t", 8, 4)) for r in range(8)}
    w = window(recs, spans=spans)
    w.slice = slice_sids
    w.trace = devtrace.Slice(window_s=slice_s)
    return w


def test_tick_readers_take_the_calls_outside_the_slice():
    # two ticks outside the slice, one (far slower) inside it
    spans = (_tick(1.0, 1.04, 0.03, 4) + _tick(2.0, 2.06, 0.02, 2)
             + _tick(3.0, 4.0, 0.9, 8))
    w = _traced(spans, (6, 14), 2.0)
    assert reader("tick_dispatch_ms.tok")(w) == pytest.approx(25.0)
    assert reader("tick_read_ms.tok")(w) == pytest.approx(25.0)
    # the counter counts every tick of the window, as rows_per_tick does
    assert reader("syncs_per_tick.tok")(w) == pytest.approx(14 / 3)
    # the existing tick reader over the same calls: the parts sum to it
    assert reader("tick_dispatch_ms.tok")(w) + \
        reader("tick_read_ms.tok")(w) == pytest.approx(
            reader("tick_ms.tok")(w))


@pytest.mark.parametrize("name,phase,want", [
    ("prefill_dispatch_ms.req", "prefill", 20.0),
    ("encode_dispatch_ms.ttft", "encode", 20.0),
    ("encode_dispatch_ms.req", "encode", 20.0),
])
def test_dispatch_readers_read_one_value_a_call(name, phase, want):
    spans = [Span("m", phase, 1.0, 1.05, rid=r, attrs={"dispatch_s": 0.01})
             for r in range(3)]
    spans += [Span("m", phase, 2.0, 2.05, rid=3, attrs={"dispatch_s": 0.03})]
    spans += [Span("m", phase, 3.0, 3.5, rid=4, attrs={"dispatch_s": 0.4})]
    w = _traced(spans, (4, 5), 1.0)
    assert reader(name)(w) == pytest.approx(want)


def test_gc_pauses_over_the_window_less_the_slice():
    spans = [Span("python", "gc", 1.0, 1.016, attrs={"generation": 2}),
             Span("python", "gc", 2.0, 2.002, attrs={"generation": 0}),
             Span("python", "gc", 9.0, 9.5, attrs={"generation": 2})]
    # the third pause lies in the 2 s slice: 18 ms over the other 8 s
    w = _traced(spans, (2, 3), 2.0)
    for name in ("gc_ms_per_s.ttft", "gc_ms_per_s.tok"):
        assert reader(name)(w) == pytest.approx(18.0 / 8.0)


@pytest.mark.parametrize("name", [
    "tick_dispatch_ms.tok", "tick_read_ms.tok", "syncs_per_tick.tok",
    "prefill_dispatch_ms.req", "encode_dispatch_ms.ttft",
    "encode_dispatch_ms.req", "gc_ms_per_s.ttft", "gc_ms_per_s.tok"])
def test_new_readers_are_silent_where_the_program_records_nothing(name):
    """A program without the spans' dispatch and sync attributes or gc
    spans gives no reading, and no error."""
    spans = [Span("vit", "encode", 1.0, 1.5, rid=0, attrs={"batch": 1}),
             Span("head", "prefill", 2.0, 2.03, rid=1,
                  attrs={"prefix_len": 264}),
             Span("head", "decode_tick", 3.0, 3.04, rid=1, attrs={"rows": 1})]
    assert reader(name)(_traced(spans, None, 0.0)) is None
    assert reader(name)(window({})) is None
