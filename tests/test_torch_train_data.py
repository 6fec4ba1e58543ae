"""The port's copies of ``training/data.py`` and ``training/elastic.py``:
``TokenStream`` gives the reference's batches exactly (synthetic corpus,
host shards, a token file, modality stubs), and the counterparts of
``tests/test_elastic.py`` (topology changes, stragglers, failover, the
elastic replan)."""

import numpy as np
import pytest

from repro.training.data import DataConfig as RefDataConfig
from repro.training.data import TokenStream as RefTokenStream
from repro_torch.training.data import DataConfig, TokenStream, write_token_file
from repro_torch.training.elastic import (
    ElasticTopology, Redispatcher, StragglerTracker,
)

STREAMS = {
    "synthetic": dict(seq_len=32, global_batch=4, vocab_size=100, seed=7),
    "tinyllama": dict(seq_len=128, global_batch=8, vocab_size=32000),
    "shard1of2": dict(seq_len=8, global_batch=4, vocab_size=100, seed=3,
                      process_index=1, process_count=2),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_token_stream_matches_reference(name):
    kw = STREAMS[name]
    extra = {"image_embeds": ((4, 16), np.float32)}
    ours = TokenStream(DataConfig(**kw), extra_features=extra)
    ref = RefTokenStream(RefDataConfig(**kw), extra_features=extra)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_file_backed_stream_matches_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    write_token_file(path, np.arange(10_000) % 251)
    kw = dict(seq_len=16, global_batch=2, vocab_size=251, path=str(path))
    a = next(TokenStream(DataConfig(**kw)))
    b = next(RefTokenStream(RefDataConfig(**kw)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["tokens"][0],
                                  (np.arange(16) % 251).astype(np.int32))


def test_topology_detects_change():
    topo = ElasticTopology(hosts={"a", "b", "c"})
    assert not topo.update({"a", "b", "c"})
    assert topo.update({"a", "b"})          # node c died
    assert topo.generation == 1
    assert topo.update({"a", "b", "d"})     # node d joined
    assert topo.data_shards() == ["a", "b", "d"]


def test_straggler_filtered():
    t = StragglerTracker(threshold=2.0)
    for _ in range(5):
        t.record("fast1", 1.0)
        t.record("fast2", 1.1)
        t.record("slow", 10.0)
    assert t.is_straggler("slow")
    assert t.healthy(["fast1", "fast2", "slow"]) == ["fast1", "fast2"]


def test_redispatch_fails_over():
    t = StragglerTracker()
    r = Redispatcher(t)
    calls = []

    def run_on(dev):
        calls.append(dev)
        if dev == "bad":
            raise RuntimeError("device lost")
        return f"ok@{dev}"

    t.record("bad", 0.1)    # looks fastest
    t.record("good", 1.0)
    out, dev = r.call("vit", ["bad", "good"], run_on)
    assert out == "ok@good" and dev == "good"
    assert calls == ["bad", "good"]


def test_redispatch_all_fail():
    r = Redispatcher(StragglerTracker())
    with pytest.raises(RuntimeError):
        r.call("m", ["x"], lambda d: (_ for _ in ()).throw(ValueError()))


def test_elastic_replan_integration():
    """Pool shrinks -> replan keeps service feasible with migrations."""
    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.core.placement import greedy_place, replan

    enc = ModuleSpec("e", "encoder", "vision", 50, flops_per_query=1e9)
    head = ModuleSpec("h", "head", "task", 10, flops_per_query=1e8)
    m = ModelSpec("m", "t", (enc,), head)
    c1 = ClusterSpec(devices=[DeviceSpec("a", 200, 2e9),
                              DeviceSpec("b", 200, 1e9)])
    pl1 = greedy_place([m], c1)
    c2 = c1.without("a")
    pl2, migrations = replan([m], c1, c2, pl1)
    assert pl2.feasible
    assert all(dev == "b" for _, dev in migrations)
