"""Options of the port's training losses: ``z_loss`` held to the JAX
package on bridged weights; the remat policies (``none``, ``full``,
``dots``) give the same loss and gradients; the kernels' path
(``attn_impl="kernel"``: attention, SSD and sLSTM through the wrappers,
which take their plain versions on the CPU) the same loss as the
differentiable one; clip's ``contrastive_loss`` and its gradients held
to the reference, on both tower paths.

Tolerance: float32 rtol = atol = 2e-4 against the reference and between
the two paths; the remat policies recompute the same operations, so they
agree to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.s2m3_zoo import CLIP_CONFIGS as REF_CLIP_CONFIGS
from repro.models import clip as JC
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.configs.s2m3_zoo import get_clip_config
from repro_torch.models import clip as C
from repro_torch.models.api import build_model
from repro_torch.training.train_step import loss_and_grads
from test_torch_losses import TOL, _batch, _close, _leaves, _ref_loss_and_grads, _torch

#: the compute every test here holds to the reference's float32 run
F32 = {"compute_dtype": torch.float32}


def test_z_loss_matches_reference():
    arch = "tinyllama-1.1b"
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg, seed=1)
    jp, jl, jm, jg = _ref_loss_and_grads(arch, batch, z_loss=1e-3)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tl, tm, tg = loss_and_grads(build_model(cfg, z_loss=1e-3, **F32), tp,
                                _torch(batch))
    plain, _, _ = loss_and_grads(build_model(cfg, **F32), tp, _torch(batch))
    _close(tl, jl)
    assert float(tl) > float(plain)
    for t, j in zip(_leaves(tg), jax.tree.leaves(jg)):
        _close(t, j)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_remat_policies_give_the_same_gradients(arch):
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg, **F32).init(torch.Generator().manual_seed(0),
                                          device="cpu")
    batch = _torch(_batch(cfg, seed=2))
    out = {r: loss_and_grads(build_model(cfg, remat=r, **F32), params, batch)
           for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        torch.testing.assert_close(out[r][0], out["none"][0], rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(_leaves(out[r][2]), _leaves(out["none"][2])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        build_model(cfg, remat="some", compute_dtype=torch.float32)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-9b",
                                  "whisper-tiny", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_kernel_path_loss_equals_plain_path_on_cpu(arch):
    """On the CPU the kernel wrappers take their plain versions, so the
    kernels' path (attention, SSD, sLSTM) and the differentiable one
    compute the same loss."""
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg, **F32).init(torch.Generator().manual_seed(0),
                                          device="cpu")
    batch = _torch(_batch(cfg, seed=3))
    with torch.no_grad():
        lk, mk = build_model(cfg, attn_impl="kernel", **F32).loss_fn(params,
                                                                     batch)
        lx, mx = build_model(cfg, attn_impl="xla", **F32).loss_fn(params,
                                                                  batch)
    torch.testing.assert_close(lk, lx, **TOL)
    with pytest.raises(ValueError):
        build_model(cfg, attn_impl="pallas", compute_dtype=torch.float32)


def test_clip_contrastive_loss_and_gradients_match_reference():
    name = "mini-clip"
    cfg = get_clip_config(name)
    jcfg = REF_CLIP_CONFIGS[name]
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: JC.init_clip(k, jcfg))(jax.random.PRNGKey(0)))
    jp["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    rng = np.random.default_rng(4)
    patches = rng.standard_normal(
        (4, cfg.n_image_tokens, cfg.vision_width)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, x, i: JC.contrastive_loss(p, x, i, jcfg)))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(patches),
            jnp.asarray(ids))
    tp = params_from_numpy(jp, "cpu")
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl = C.contrastive_loss(tp, torch.from_numpy(patches),
                            torch.from_numpy(ids), cfg)
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl)
    for t, j in zip(grads, jax.tree.leaves(jg)):
        _close(t, j)
    with torch.no_grad():
        tk = C.contrastive_loss(tp, torch.from_numpy(patches),
                                torch.from_numpy(ids), cfg, impl="kernel")
    _close(tk, jl)
