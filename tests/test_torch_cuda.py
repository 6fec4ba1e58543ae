"""The hand-written CUDA kernels against their plain versions on the
card, at the serving path's shapes (internvl2-1b: H=14, K=2, D=64).

Marked ``cuda``: they skip where no CUDA device is visible.  This file
imports no jax, so it runs on a machine with the card alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 2e-4, 2e-4),
    # both sides round one f32 result to bf16: at most one ulp apart
    (torch.bfloat16, 1e-3, 2.0**-7)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, atol, rtol):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, 267, 14, 64), rnd(1, 267, 2, 64), rnd(1, 267, 2, 64)
    for kw in (dict(), dict(softcap=30.0), dict(window=50)):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **kw).float(),
            ref.flash_attention_ref(q, k, v, **kw).float(), rtol=rtol, atol=atol)
    qd = rnd(4, 14, 64)
    kd, vd = rnd(4, 296, 2, 64), rnd(4, 296, 2, 64)
    lens = torch.tensor([296, 1, 150, 0], dtype=torch.int32,
                        device=cuda_device)
    torch.testing.assert_close(
        ops.decode_attention(qd, kd, vd, lens, softcap=30.0).float(),
        ref.decode_attention_ref(qd, kd, vd, lens, softcap=30.0).float(),
        rtol=rtol, atol=atol)
    kp, vp = rnd(129, 16, 2, 64), rnd(129, 16, 2, 64)
    tables = torch.randint(-5, 134, (4, 32), generator=g, device=cuda_device,
                           dtype=torch.int32)
    lens = torch.tensor([300, 17, 512, 0], dtype=torch.int32,
                        device=cuda_device)
    torch.testing.assert_close(
        ops.paged_decode_attention(qd, kp, vp, tables, lens).float(),
        ref.paged_decode_attention_ref(qd, kp, vp, tables, lens).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_model_steps_match_cpu_plain_path(cuda_device):
    """internvl2-1b smoke through the kernels on the card == the same
    weights through the plain versions on the CPU (which the CPU tests
    hold to the JAX package), for prefill, dense and paged decode."""
    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.models.api import build_model
    from repro_torch.serving.kvcache import insert_pages

    cfg = get_config("internvl2-1b", smoke=True)
    b = build_model(cfg)
    p_cpu = b.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 9), generator=g,
                                     dtype=torch.int32),
             "image_embeds": torch.randn(1, cfg.n_image_tokens, cfg.d_model,
                                         generator=g)}
    L = cfg.n_image_tokens + 9
    outs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        dense = b.init_cache(1, 32, torch.float32, dev)
        logits, dense = b.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                                  dense)
        got = [logits.cpu()]
        pool = insert_pages(b.init_paged_cache(9, 8, torch.float32, dev),
                            dense, [4, 7, 2], L)
        tables = torch.tensor([[4, 7, 2, 5], [0, 0, 0, 0]], dtype=torch.int32,
                              device=dev)
        for i in range(3):
            lens = torch.tensor([L + i, 0], dtype=torch.int32, device=dev)
            tok = torch.tensor([[i + 1], [0]], dtype=torch.int32, device=dev)
            logits, pool = b.paged_decode_step(p, tok, pool, tables, lens)
            got.append(logits[:1].cpu())
            logits, dense = b.decode_step(p, tok[:1], dense, lens[:1])
            got.append(logits.cpu())
        outs[str(dev)] = got
    for a, c in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(c, a, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_sampled_serve_equals_submit(cuda_device):
    """Sampled decode draws on the card, from a generator seeded from
    the rid there: the batched paged stream and the solo path pick the
    same tokens."""
    import numpy as np

    from repro_torch.common.config import get_config
    from repro_torch.models.api import build_model
    from repro_torch.s2m3 import Request
    from repro_torch.serving.scheduler import SchedulerConfig, lm_scheduler

    cfg = get_config("internvl2-1b", smoke=True)
    b = build_model(cfg)
    params = b.init(torch.Generator(device=cuda_device).manual_seed(0),
                    torch.float32, cuda_device)
    sched = lm_scheduler(b, params, device=cuda_device,
                         config=SchedulerConfig(decode_rows=2, page_size=8,
                                                max_seq_len=48,
                                                decode_pages=20))
    img = np.random.default_rng(5).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    reqs = [Request(rid=i, model="lm", source="dev0", prompt=(5 + i, 9),
                    max_new_tokens=6, temperature=0.8,
                    inputs={"vision": img}) for i in range(3)]
    for req, res in zip(reqs, sched.serve(reqs)):
        np.testing.assert_array_equal(res.output,
                                      sched.engine.generate(req).output)
