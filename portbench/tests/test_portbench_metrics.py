"""The metric readers on hand-made windows: a tail over every request
due, rates over all of the window with a stall in it, the span and
counter readers, and the device readers' silence without a trace."""

import importlib.util
import math
from dataclasses import dataclass, field
from pathlib import Path

import pytest

from portbench import harness, traffic

MET = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, harness.reader_path(MET, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Span:
    name: str
    phase: str
    t0: float
    t1: float
    rid: int = None
    sid: int = 0
    attrs: dict = field(default_factory=dict)


class FlatWork:
    """A configuration's ``call_work`` stand-in: 1 GFLOP a request."""

    def call_work(self, call):
        return [("model", 1e9 * len(call["rids"]), 0)]


def window(recs, due=(), spans=(), finished_in=0, t_open=100.0,
           t_close=110.0, stats_open=None, stats_close=None):
    spans = list(spans)
    for i, s in enumerate(spans):
        s.sid = i
    w = harness.Window(
        bench=FlatWork(), setup_s=3.0,
        t_open=t_open, t_close=t_close, recs=recs, due=list(due),
        finished_in=finished_in, stats_open=stats_open or {},
        stats_close=stats_close or {}, spans=spans, win=(0, len(spans)),
        slice=None, clock_offset=0.0, peak_bytes=2_500_000_000)
    w.calls = harness.unique_calls(spans, 0, len(spans), recs)
    return w


def open_recs(latencies):
    recs = {}
    for rid, lat in enumerate(latencies):
        due = 100.0 + 0.01 * rid
        recs[rid] = harness.Rec(traffic.Spec(rid, "classify", 0, 0, due),
                                due=due, t_submit=due, t_finish=due + lat)
    return recs


def test_p95_is_over_every_request_due():
    lat = [0.010] * 95 + [0.5] * 5
    recs = open_recs(lat)
    assert reader("ttft_p95_ms")(window(recs, due=recs)) == \
        pytest.approx(10.0)
    lat = [0.010] * 94 + [0.5] * 6
    recs = open_recs(lat)
    assert reader("ttft_p95_ms")(window(recs, due=recs)) == \
        pytest.approx(500.0)


def test_a_stall_shows_in_the_tail_and_the_rates():
    # a 2 s stall at 104 s: every request due in it waits for its end
    lat = []
    for rid in range(1000):
        due = 100.0 + 0.01 * rid
        lat.append(max(106.0 - due, 0.0) + 0.01 if 104.0 <= due < 106.0
                   else 0.01)
    recs = open_recs(lat)
    w = window(recs, due=recs, finished_in=800)
    assert reader("ttft_p95_ms")(w) > 1000.0
    # requests finished over all 10 s of the window, stall included
    assert reader("req_per_s")(w) == pytest.approx(80.0)


def test_a_request_that_never_finished_is_infinitely_late():
    recs = open_recs([0.01] * 10)
    recs[3].t_finish = math.nan
    assert reader("ttft_p95_ms")(window(recs, due=recs)) == math.inf


def test_first_token_of_a_generative_request_is_its_prefill_end():
    recs = open_recs([1.0] * 20)
    spans = []
    for rid, r in recs.items():
        r.spec = traffic.Spec(rid, "caption", 8, 16, r.due)
        spans.append(Span("head", "prefill", r.due + 0.02, r.due + 0.05,
                          rid=rid, attrs={"prefix_len": 264}))
    assert reader("ttft_p95_ms")(window(recs, due=recs, spans=spans)) == \
        pytest.approx(50.0)


def test_tokens_over_the_window_from_the_stats():
    w = window({}, stats_open={"head": {"decode_tokens": 100, "prefills": 5,
                                        "decode_steps": 10}},
               stats_close={"head": {"decode_tokens": 2100, "prefills": 25,
                                     "decode_steps": 60},
                            "enc": {"calls": 3}})
    assert reader("tokens_per_s")(w) == pytest.approx(2020 / 10)
    assert reader("rows_per_tick.tok")(w) == pytest.approx(2000 / 50)


def test_span_readers_group_a_batch_into_one_call():
    spans = [Span("vit", "encode", 1.0, 1.5, rid=r, attrs={"batch": 4})
             for r in range(4)]
    spans += [Span("vit", "encode", 2.0, 2.25, rid=9, attrs={"batch": 1})]
    spans += [Span("head", "decode_tick", 3.0, 3.04, rid=r)
              for r in range(3)]
    spans += [Span("head", "prefill", 4.0, 4.03, rid=7)]
    spans += [Span("vit", "admission", 0.5, 1.0, rid=r) for r in range(4)]
    recs = {r: harness.Rec(traffic.Spec(r, "t", 8, 4)) for r in range(10)}
    w = window(recs, spans=spans)
    assert reader("enc_batch_mean.ttft")(w) == pytest.approx(2.5)
    assert reader("tick_ms.tok")(w) == pytest.approx(40.0)
    assert reader("prefill_ms.req")(w) == pytest.approx(30.0)
    assert reader("queue_wait_ms.ttft")(w) == pytest.approx(500.0)
    # 4 + 1 + 3 + 1 requests' GFLOP over 10 s at 67 TFLOP/s
    assert reader("mfu.tok")(w) == pytest.approx(100 * 9e9 / (10 * 67e12))


@pytest.mark.parametrize("name", [
    "idle_share.ttft", "idle_share.tok", "idle_share.req",
    "flash_attention_roofline.ttft", "flash_attention_roofline.req",
    "paged_decode_attention_roofline.tok"])
def test_device_readers_are_silent_without_a_trace(name):
    assert reader(name)(window({})) is None


def test_setup_and_peak():
    w = window({})
    assert reader("setup_s")(w) == 3.0
    assert reader("peak_mem_gb")(w) == pytest.approx(2.5)


def test_a_suffixed_name_falls_back_to_its_base_reader(tmp_path):
    (tmp_path / "mfu.py").write_text("")
    assert harness.reader_path(tmp_path, "mfu.tok") == tmp_path / "mfu.py"
    (tmp_path / "mfu.tok.py").write_text("")
    assert harness.reader_path(tmp_path, "mfu.tok") == \
        tmp_path / "mfu.tok.py"
    assert harness.reader_path(MET, "idle_share.req").name == "idle_share.py"


class Answer:
    def __init__(self, rid):
        self.rid, self.output = rid, None


class Kept:
    results: dict = {}

    def keep(self, result):
        return result.rid


def test_the_kept_sample_is_drawn_over_the_window_alone():
    """Answers before the window (a closed loop's fill) are never kept;
    each task's reservoir holds its quota of window answers, and every
    window answer has its chance, the late ones too."""
    mix = {"tasks": [{"task": "a", "share": 1}, {"task": "b", "share": 1}]}
    plan = traffic.Plan(mix, "closed", [])
    late = 0
    for seed in range(40):
        d = harness.Driver(Kept(), plan, Kept(), 8, seed)
        for rid in range(400):
            d.recs[rid] = harness.Rec(traffic.Spec(rid, "ab"[rid % 2], 0, 0))
            if rid == 100:
                d.window = (0.0, None)
            d.on_finish(Answer(rid))
        kept = d.kept
        assert len(kept) == 8 and all(rid >= 100 for rid in kept)
        assert sum(1 for rid in kept if rid % 2) == 4
        late += sum(1 for rid in kept if rid >= 250)
    # half the window's answers come at 250 or later: about half the kept
    assert 0.35 < late / (40 * 8) < 0.65
