"""The reader of the decode ticks' graph share on hand-made windows: one
value a tick however many rows it has, the profiled slice left out, and
silence where no tick carries ``graph``."""

import pytest

from portbench import devtrace, harness, traffic
from test_portbench_metrics import Span, reader, window

NAMES = ["decode_graph_share.tok", "decode_graph_share.req"]


def _tick(t0, rows, graph=None):
    attrs = {"rows": rows, "dispatch_s": 0.001, "syncs": 1}
    if graph is not None:
        attrs["graph"] = graph
    return [Span("head", "decode_tick", t0, t0 + 0.01, rid=r, attrs=attrs)
            for r in range(rows)]


def _window(spans, slice_sids=None):
    recs = {r: harness.Rec(traffic.Spec(r, "t", 8, 4)) for r in range(8)}
    w = window(recs, spans=spans)
    if slice_sids is not None:
        w.slice = slice_sids
        w.trace = devtrace.Slice(window_s=1.0)
    return w


@pytest.mark.parametrize("name", NAMES)
def test_the_share_counts_ticks_not_rows(name):
    # an eager tick of 6 rows and three replays of 1, 2 and 3 rows
    spans = (_tick(1.0, 6, 0) + _tick(2.0, 1, 1) + _tick(3.0, 2, 1)
             + _tick(4.0, 3, 1))
    assert reader(name)(_window(spans)) == pytest.approx(75.0)


@pytest.mark.parametrize("name", NAMES)
def test_the_profiled_slice_is_left_out(name):
    # two replays outside the slice; the eager tick lies in it (sids 2-4)
    spans = _tick(1.0, 2, 1) + _tick(2.0, 3, 0) + _tick(3.0, 1, 1)
    assert reader(name)(_window(spans, (2, 5))) == pytest.approx(100.0)
    assert reader(name)(_window(spans)) == pytest.approx(200.0 / 3)


@pytest.mark.parametrize("name", NAMES)
def test_silent_where_no_tick_carries_graph(name):
    spans = [Span("head", "prefill", 0.5, 0.6, rid=9,
                  attrs={"dispatch_s": 0.05, "syncs": 1})]
    spans += _tick(1.0, 2) + _tick(2.0, 3)
    assert reader(name)(_window(spans)) is None
    assert reader(name)(window({})) is None
