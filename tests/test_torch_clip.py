"""The port's CLIP dual encoder held to the JAX package's
(``repro.models.clip``) on bridged weights at float32 2e-4: each tower,
the retrieval head and the monolithic forward on mini-clip and
mini-clip-l; the plain flash attention against the Pallas kernel in
interpret mode at the towers' head dim 16; the scenario's split and
batched paths against the monolithic forward; and the port's
``examples/multi_task_serving`` run to its end on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.s2m3_zoo import CLIP_CONFIGS as REF_CLIP_CONFIGS
from repro.kernels import ops as jops
from repro.models import clip as JC
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs.s2m3_zoo import CLIP_CONFIGS, get_clip_config
from repro_torch.kernels import ops
from repro_torch.models import clip as C

TOL = dict(rtol=2e-4, atol=2e-4)
CONFIGS = ["mini-clip", "mini-clip-l"]


@pytest.fixture(scope="module", params=CONFIGS)
def bridged(request):
    cfg = get_clip_config(request.param)
    jp = JC.init_clip(jax.random.PRNGKey(0), REF_CLIP_CONFIGS[request.param])
    jp = jax.tree.map(np.asarray, jp)
    # a non-zero logit scale, so the head's exp(scale) is exercised
    jp["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(3)
    patches = rng.standard_normal(
        (3, cfg.n_image_tokens, cfg.vision_width)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    return cfg, REF_CLIP_CONFIGS[request.param], jp, tp, patches, ids


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_clip_configs_equal_reference():
    assert list(CLIP_CONFIGS) == list(REF_CLIP_CONFIGS)
    for name, want in REF_CLIP_CONFIGS.items():
        assert dataclasses.asdict(CLIP_CONFIGS[name]) == \
            dataclasses.asdict(want)


def test_specs_init_and_bridge_carry_every_leaf(bridged):
    """init_tree and the bridge give the reference's leaves, the 0-d
    ``logit_scale`` included."""
    cfg, _, jp, tp, _, _ = bridged
    init = C.init_clip(torch.Generator().manual_seed(0), cfg, "cpu")
    want = sorted(tuple(x.shape) for x in jax.tree.leaves(jp))
    assert sorted(tuple(x.shape) for x in tree_leaves(init)) == want
    assert sorted(tuple(x.shape) for x in tree_leaves(tp)) == want
    assert init["logit_scale"].shape == () and \
        float(init["logit_scale"]) == 0.0
    assert tp["logit_scale"].shape == ()


def test_init_clip_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.init_clip(torch.Generator().manual_seed(0),
                    get_clip_config("mini-clip"))


@pytest.mark.parametrize("what", ["encode_image", "encode_text",
                                  "retrieval_logits", "clip_forward"])
def test_clip_matches_reference(bridged, what):
    cfg, jcfg, jp, tp, patches, ids = bridged
    tpatch, tids = torch.from_numpy(patches), torch.from_numpy(ids)
    if what == "encode_image":
        _close(C.encode_image(tp["vision"], tpatch, cfg),
               JC.encode_image(jp["vision"], patches, jcfg))
    elif what == "encode_text":
        _close(C.encode_text(tp["text"], tids, cfg),
               JC.encode_text(jp["text"], ids, jcfg))
    elif what == "retrieval_logits":
        rng = np.random.default_rng(4)
        zi, zt = (rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
                  for _ in range(2))
        _close(C.retrieval_logits(torch.from_numpy(zi),
                                  torch.from_numpy(zt), tp["logit_scale"]),
               JC.retrieval_logits(zi, zt, jp["logit_scale"]))
    else:
        _close(C.clip_forward(tp, tpatch, tids, cfg),
               JC.clip_forward(jp, patches, ids, jcfg))


@pytest.mark.parametrize("causal,S", [(False, 16), (True, 12)],
                         ids=["vision", "text"])
def test_plain_flash_matches_pallas_at_tower_shapes(causal, S):
    """The towers' attention: H = K = 4 heads of 16, the vision tower's
    16 patches non-causal and the text tower's 12 tokens causal."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    pallas = jops.flash_attention(q, k, v, causal=causal, block_q=S,
                                  block_k=S, interpret=True)
    _close(out, pallas)


@pytest.fixture(scope="module")
def scenario():
    from repro_torch.examples import multi_task_serving as ex

    dep, _, params, ccfg = ex.build_deployment("cpu")
    patches, ids = ex.make_inputs(ccfg)
    return ex, dep, params, ccfg, patches, ids


def test_split_submit_equals_monolithic(scenario):
    from repro_torch.s2m3 import Request

    _, dep, params, ccfg, patches, ids = scenario
    res = dep.submit(Request(0, "retrieval", "dev0",
                             inputs={"vision": patches, "text": ids}))
    mono = C.clip_forward(params, torch.from_numpy(patches),
                          torch.from_numpy(ids), ccfg)
    assert res.output.shape == (4, 4)
    torch.testing.assert_close(res.output, mono, rtol=0, atol=0)


def test_serve_equals_submit(scenario):
    from repro_torch.s2m3 import Request

    _, dep, _, _, patches, ids = scenario
    inputs = {"retrieval": {"vision": patches, "text": ids},
              "classify": {"vision": patches},
              "vqa": {"vision": patches, "text": ids}}
    burst = [Request(20 + i, task, "dev0", inputs=inputs[task],
                     slo_deadline=2.0)
             for i, task in enumerate(["retrieval", "classify", "vqa"] * 2)]
    served = dep.serve(burst, max_batch=8)
    assert dep.scheduler.cross_task_batches >= 1
    for req, res in zip(burst, served):
        torch.testing.assert_close(res.output, dep.submit(req).output,
                                   **TOL)


def test_example_runs_through_on_the_cpu(tmp_path):
    from repro_torch.examples import multi_task_serving as ex

    out = ex.main(device="cpu", trace_path=tmp_path / "trace.json")
    for sim, real in out["routes"]:
        assert sim == real
    assert out["verify"] == []
    assert out["tampered_finding"].code == "plan/memory-overflow"
    assert out["split_diff"] == 0.0 and out["batched_diff"] <= 2e-4
    assert out["cross_task_batches"] >= 1
    assert [r["model"] for r in out["slo"]] == ["classify", "retrieval", "vqa"]
    assert all(r["requests"] == 3 for r in out["slo"])
    assert out["drift"].n_route_divergences == 0
    assert out["drift"].routes_checked > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert out["evicted"] == ["mini-lm"]
    assert "dev0" not in out["after_replan"].devices.values()
