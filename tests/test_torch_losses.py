"""The port's training losses held to the JAX package's on bridged
weights: ``ModelBundle.loss_fn`` of all ten archs at their smoke configs
(the reference at ``compute_dtype=jnp.float32``), the loss, each metric
(``ce``, the MoE router ``aux``, deepseek's ``mtp``) and the gradient of
every leaf.  ``tests/test_torch_loss_options.py`` holds the options
(``z_loss``, remat, the kernels' path) and clip's contrastive loss.

Tolerance: float32 rtol = atol = 2e-4 (another summation order, the
tolerance of ``tests/test_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.models.api import build_model as ref_build_model
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config, list_archs
from repro_torch.models.api import build_model
from repro_torch.training.train_step import loss_and_grads

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["internvl2-1b", "tinyllama-1.1b", "llama3-8b", "llama3-405b",
         "gemma2-9b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "whisper-tiny", "xlstm-1.3b", "zamba2-7b"]


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                    # a ragged row: masked targets
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    if cfg.has_vision_stub:
        batch["image_embeds"] = 0.1 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["audio_frames"] = 0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_loss_and_grads(arch, batch, **opts):
    cfg = ref_get_config(arch, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32, **opts)
    jp = jax.jit(jb.init)(jax.random.PRNGKey(0))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jp, loss, metrics, grads


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_every_registered_arch_is_covered():
    assert sorted(ARCHS) == list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_gradients_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg)
    jp, jl, jm, jg = _ref_loss_and_grads(arch, batch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tl, tm, tg = loss_and_grads(build_model(cfg, compute_dtype=torch.float32),
                                tp, _torch(batch))
    _close(tl, jl)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k])
    if cfg.n_experts:                      # the router term is in the loss
        assert float(tm["aux"]) > 0.0
        np.testing.assert_allclose(
            float(tl), float(tm["ce"]) + cfg.router_aux_loss * float(tm["aux"])
            + 0.3 * float(tm.get("mtp", 0.0)), rtol=1e-6)
    if cfg.mtp_depth:                      # deepseek's MTP term too
        assert float(tm["mtp"]) > 0.0
    t_leaves, j_leaves = _leaves(tg), jax.tree.leaves(jg)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert any(float(t.abs().max()) > 0 for t in t_leaves)
