"""dots-vlm1.ocr's readers and work on hand-made windows: the share of
the held experts' computed rows that carry a routed pair, the absorbed
latent decode's work and its roofline share, each silent where the
program records nothing for it."""

import pytest

from portbench import devtrace, harness, mla_work, traffic, work
from test_portbench_metrics import Span, reader, window


class Held:
    """A configuration's stand-in: one layer of paged MLA work a
    tick."""

    def call_work(self, call):
        if call["phase"] != "decode_tick":
            return []
        keys = [1100 + s.prompt for s in call["specs"]]
        b, f = mla_work.paged_mla_work(64, 128, 512, 64, 16, keys)
        return [("paged_mla_decode", f, b)]


#: the rows a tick's held experts compute: 8 held experts in 9 MoE
#: layers over 64 row slots
ROWS = 8 * 9 * 64


def _tick(t0, rows, pairs=None):
    attrs = {"rows": rows, "dispatch_s": 0.001, "syncs": 1, "graph": 1}
    if pairs is not None:
        attrs.update(expert_pairs=pairs, expert_rows=ROWS)
    return [Span("head", "decode_tick", t0, t0 + 0.04, rid=r, attrs=attrs)
            for r in range(rows)]


def _window(spans):
    recs = {r: harness.Rec(traffic.Spec(r, "ocr", 32, 640)) for r in range(8)}
    w = window(recs, spans=spans)
    w.bench = Held()
    return w


def test_expert_routed_share_reads_one_value_a_tick():
    # ticks of 6 and 2 rows routing 144 and 72 pairs to the held experts
    w = _window(_tick(1.0, 6, 144) + _tick(2.0, 2, 72))
    assert reader("expert_routed_share.tok")(w) == pytest.approx(
        100.0 * 216 / (2 * ROWS))


def test_expert_routed_share_is_silent_without_the_attribute():
    assert reader("expert_routed_share.tok")(_window(_tick(1.0, 3))) is None


def test_paged_mla_work_counts_each_live_key_once():
    b, f = mla_work.paged_mla_work(4, 128, 512, 64, 16, [16, 17, 0])
    assert f == 2.0 * 128 * 33 * (512 + 64 + 512)
    assert b == (33 * 576 * 4 + 4 * 128 * (2 * 512 + 64) * 4
                 + 4 * (1 + 2 + 0) + 4 * 4)


def test_roofline_reads_the_slice_and_is_silent_without_it():
    spans = _tick(1.0, 2, 48)
    w = _window(spans)
    name = "paged_mla_decode_roofline.tok"
    assert reader(name)(w) is None                   # no profiled slice
    w.slice = (0, len(spans))
    w.slice_calls = harness.unique_calls(spans, 0, len(spans), w.recs)
    w.trace = devtrace.Slice(window_s=1.0, ops=[
        ("paged_mla_decode_kernel(float const*)", 0.0, 800.0),
        ("paged_mla_merge_kernel(float const*)", 800.0, 1000.0),
        ("sm80_xmma_gemm", 1000.0, 5000.0)])
    b, f = Held().call_work(w.slice_calls[0])[0][1:][::-1]
    want = 100.0 * work.bound_s(b, f) / 1e-3
    assert reader(name)(w) == pytest.approx(want)
    w.trace.ops = [("sm80_xmma_gemm", 0.0, 10.0)]    # the parent's kernels
    assert reader(name)(w) is None
