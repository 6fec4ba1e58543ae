"""The paged decode tick's CUDA graph (``serving.decode``): when it
engages, one read a tick for the greedy rows on the eager path, the
sampled rows' own generator streams, and the launch counts a replay
applies from what its capture recorded (``kernels.ops.recording``).

The ``cuda``-marked tests hold the graph's replays to the eager step on
the card; they skip where no CUDA device is visible.  This file imports
no jax, so it runs on a machine with the card alone:

    python -m pytest -q tests/test_torch_decode_graph.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.s2m3 import Request
from repro_torch.serving.decode import DecodeStream
from repro_torch.serving.scheduler import SchedulerConfig, lm_scheduler

CUDA = torch.device("cuda")


def _seq(temperature):
    return SimpleNamespace(request=SimpleNamespace(temperature=temperature))


def _rt(device, mesh=None):
    return SimpleNamespace(device=torch.device(device),
                           bundle=SimpleNamespace(mesh=mesh))


@pytest.mark.parametrize("device,mesh,temps,want", [
    ("cuda", None, (0.0, 0.0), True),
    ("cuda", None, (0.0,), True),
    ("cpu", None, (0.0, 0.0), False),
    ("cuda", "a mesh", (0.0, 0.0), False),
    ("cuda", None, (0.0, 0.7), False),
    ("cuda", None, (0.7,), False),
])
def test_the_graph_engages_on_a_cuda_decoder_without_mesh_all_greedy(
        device, mesh, temps, want):
    live = [(row, _seq(t)) for row, t in enumerate(temps)]
    assert DecodeStream.graph_engages(_rt(device, mesh), live) is want


CFG = get_config("internvl2-1b", smoke=True)


def _sched(device, rows=3, max_seq_len=48):
    bundle = build_model(CFG, compute_dtype=torch.float32)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device=device)
    pages = rows * -(-max_seq_len // 8) + 1
    return lm_scheduler(bundle, params, device=device, config=SchedulerConfig(
        decode_rows=rows, page_size=8, max_seq_len=max_seq_len,
        decode_pages=pages, debug_invariants=False))


def _requests(temps, new=(3, 6, 2, 5, 7, 4), base=0):
    img = np.random.default_rng(5).standard_normal(
        (CFG.n_image_tokens, CFG.d_model)).astype(np.float32)
    return [Request(rid=base + i, model="lm", source="dev0",
                    prompt=(5 + i, 9, 2 * i + 1), temperature=t,
                    max_new_tokens=new[i % len(new)], inputs={"vision": img})
            for i, t in enumerate(temps)]


def _ticks(sched):
    ticks: dict = {}
    for s in sched.tracer.trace.spans:
        if s.phase == "decode_tick":
            ticks.setdefault((s.t0, s.t1), []).append(s)
    return list(ticks.values())


def _stream(sched):
    return next(iter(sched.decode.values()))


def test_an_all_greedy_eager_tick_reads_once_and_equals_generate():
    sched = _sched("cpu")
    reqs = _requests([0.0] * 5)
    out = {r.rid: r.output for r in sched.serve(reqs)}
    ticks = _ticks(sched)
    assert any(len(rows) > 1 for rows in ticks)
    for rows in ticks:
        assert {s.attrs["syncs"] for s in rows} == {1}
        assert {s.attrs["graph"] for s in rows} == {0}
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid],
                                      sched.engine.generate(r).output)
    stream = _stream(sched)
    assert (stream.graph_captures, stream.graph_replays) == (0, 0)


def test_a_mixed_tick_keeps_each_sampled_rows_generator():
    """Greedy and sampled rows in one batch: each sampled row draws from
    its own rid's generator, so every request's tokens equal its solo
    ``generate()``; a tick reads once for its greedy rows and once for
    each sampled row."""
    sched = _sched("cpu")
    temps = [0.0, 0.9, 0.0, 1.3, 0.6, 0.0]
    reqs = _requests(temps, base=40)
    out = {r.rid: r.output for r in sched.serve(reqs)}
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid],
                                      sched.engine.generate(r).output)
    temp = {r.rid: r.temperature for r in reqs}
    mixed = 0
    for rows in _ticks(sched):
        sampled = sum(temp[s.rid] > 0 for s in rows)
        greedy = len(rows) - sampled
        mixed += bool(sampled and greedy)
        assert {s.attrs["syncs"] for s in rows} == {(greedy > 0) + sampled}
    assert mixed


@pytest.fixture
def counted():
    """Launch counts and a work hook from zero, restored after."""
    launches = dict(ops.LAUNCHES)
    shapes = {k: dict(v) for k, v in ops.SHAPE_LAUNCHES.items()}
    heard = []
    ops.reset_launches()
    ops.WORK_HOOKS.append(lambda *a: heard.append(a))
    yield heard
    ops.WORK_HOOKS.pop()
    ops.LAUNCHES.update(launches)
    for k, v in shapes.items():
        ops.SHAPE_LAUNCHES[k].clear()
        ops.SHAPE_LAUNCHES[k].update(v)


@pytest.mark.parametrize("n", [1, 3])
def test_a_recorded_capture_applies_n_replays_launches(counted, n):
    """The wrappers' counts and work reports made while a graph captures
    are kept, not applied; each replay applies them once.  The paged
    wrapper reports its work on meta tensors as on the card, and the
    count stands for the launch its card path counts."""
    meta = torch.device("meta")
    B, H, K, D, P, ps, n_max = 4, 14, 2, 64, 20, 16, 5
    key = (B, n_max, ps, H, K, D, 0)

    def step():
        ops.paged_decode_attention(
            torch.empty(B, H, D, device=meta),
            torch.empty(P, ps, K, D, device=meta),
            torch.empty(P, ps, K, D, device=meta),
            torch.empty(B, n_max, dtype=torch.int32, device=meta),
            torch.empty(B, dtype=torch.int32, device=meta))
        ops._count("paged_decode_attention", key, torch.float32)

    step()
    once = list(counted)
    assert len(once) == 1 and ops.LAUNCHES["paged_decode_attention"] == 1
    ops.reset_launches()
    counted.clear()
    with ops.recording() as tape:
        for _ in range(2):                      # two layers a step
            step()
    assert counted == [] and ops.LAUNCHES["paged_decode_attention"] == 0
    assert len(tape) == 4
    for _ in range(n):
        ops.replay_tape(tape)
    assert ops.LAUNCHES["paged_decode_attention"] == 2 * n
    assert ops.SHAPE_LAUNCHES["paged_decode_attention"] == {
        (*key, "float32"): 2 * n}
    assert counted == once * (2 * n)
    assert sum(ops.LAUNCHES.values()) == 2 * n


def test_recording_nests_and_restores():
    with ops.recording() as outer:
        ops._count("flash_attention", (1,), torch.float32)
        with ops.recording() as inner:
            ops._count("decode_attention", (2,), torch.float32)
        ops._count("flash_attention", (3,), torch.float32)
    assert [args[1] for _, args in outer] == [(1,), (3,)]
    assert [args[1] for _, args in inner] == [(2,)]


# -- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return CUDA


def _eager(monkeypatch):
    monkeypatch.setattr(DecodeStream, "graph_engages",
                        staticmethod(lambda rt, live: False))


def _serve_both(monkeypatch, temps, new):
    """The same requests served with the graph and eagerly, each on a
    fresh scheduler over the same weights: (graph's scheduler and
    outputs, eager's)."""
    runs = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                _eager(m)
            sched = _sched(CUDA, rows=4, max_seq_len=64)
            out = {r.rid: r.output
                   for r in sched.serve(_requests(temps, new))}
            torch.cuda.synchronize()
            runs.append((sched, out))
    return runs


@pytest.mark.cuda
def test_graph_ticks_equal_eager_ticks(card, monkeypatch):
    """Over 40 and more ticks, rows joining and finishing: the graph's
    replays give the eager step's tokens and page pool."""
    new = (9, 20, 4, 14, 25, 7, 12, 18, 5, 22)
    (gs, g_out), (es, e_out) = _serve_both(monkeypatch, [0.0] * 10, new)
    g, e = _stream(gs), _stream(es)
    assert g.decode_steps >= 40
    assert (g.graph_captures, g.graph_replays) == (1, g.decode_steps - 1)
    assert (e.graph_captures, e.graph_replays) == (0, 0)
    assert g_out.keys() == e_out.keys()
    for rid in g_out:
        np.testing.assert_array_equal(g_out[rid], e_out[rid])
    for a, b in zip(tree_leaves(g.cache), tree_leaves(e.cache)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    graphed = [rows[0].attrs["graph"] for rows in _ticks(gs)]
    assert graphed[0] == 0 and set(graphed[1:]) == {1}
    assert {s.attrs["syncs"] for rows in _ticks(gs) for s in rows} == {1}


@pytest.mark.cuda
def test_a_replay_counts_the_captured_launches(card):
    sched = _sched(CUDA, rows=4, max_seq_len=64)
    before = ops.LAUNCHES["paged_decode_attention"]
    sched.serve(_requests([0.0] * 6, (9, 12, 4, 6)))
    stream = _stream(sched)
    assert stream.graph_replays > 0
    assert ops.LAUNCHES["paged_decode_attention"] - before == \
        stream.decode_steps * CFG.n_layers


@pytest.mark.cuda
def test_the_graph_is_captured_again_after_the_parameters_move(
        card, monkeypatch):
    """The parameters cloned mid-stream: the next tick captures again
    at their new addresses, and the tokens stay the eager step's."""
    new = (20, 24, 16, 22)
    with monkeypatch.context() as m:
        _eager(m)
        want = {r.rid: r.output for r in _sched(
            CUDA, rows=4, max_seq_len=64).serve(_requests([0.0] * 4, new))}
    sched = _sched(CUDA, rows=4, max_seq_len=64)
    for r in _requests([0.0] * 4, new):
        sched.submit(r)
    for _ in range(8):
        sched.step()
    stream = _stream(sched)
    rt = sched.engine.decoder_runtime(stream.module)
    assert stream.graph_captures == 1 and stream.graph_replays > 0
    replays = stream.graph_replays
    rt.params = tree_map(torch.clone, rt.params)
    while sched.step():
        pass
    assert stream.graph_captures == 2
    assert stream.graph_replays > replays
    for rid, out in want.items():
        np.testing.assert_array_equal(sched.results[rid].output, out)
