"""AdamW over the port's parameter trees, the reference's
``training/optimizer.py`` in torch.

The state is a dict ``{"step", "params", "m", "v"}``: ``step`` a 0-d
int32 tensor on the parameters' device, ``m``/``v`` trees of the
parameters' shapes in ``moment_dtype`` (float32, or bfloat16: the
DeepSeek-V3 trick that halves the moments).  ``adamw_update`` updates
the state's tensors in place and returns it: the reference donates its
state to the jitted step, so each leaf's memory is reused there too.
The update math is the reference's, in float32, weight decay on every
leaf with ``ndim >= 2`` (on the stacked layers' ``(layers, d)`` norm
scales too, as the reference's rule reads).

Optional int8 gradient compression (stochastic rounding) quantises each
leaf against its own scale.  Its noise comes from a seeded
``torch.Generator``, not the reference's ``jax.random`` keys, so the
rounding cannot match the reference bit for bit; ``quantize_int8``
takes the noise as an argument so the quantiser itself can be held to
the reference on shared noise.  Sharding the state arrives with the
distributed slice; this optimizer runs in one process.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import global_norm, tree_leaves, tree_map
from repro_torch.layers.initializers import WSpec

F32 = torch.float32
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def moment_dtype(tcfg: TrainConfig) -> torch.dtype:
    if tcfg.moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {tcfg.moment_dtype!r} is not one of "
                         f"{sorted(MOMENT_DTYPES)}")
    return MOMENT_DTYPES[tcfg.moment_dtype]


def lr_schedule(tcfg: TrainConfig, step):
    """Linear warmup to ``learning_rate``, then a cosine to 10 % of it at
    ``total_steps``; ``step`` an int tensor, the lr a float32 tensor on
    its device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - tcfg.warmup_steps)
        / max(tcfg.total_steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def state_specs(param_specs, tcfg: TrainConfig):
    """The WSpec tree of the whole optimizer state."""
    mdt = moment_dtype(tcfg)

    def moment(ws: WSpec) -> WSpec:
        return replace(ws, init="zeros", dtype=mdt)

    return {
        "step": WSpec((), (), init="zeros", dtype=torch.int32),
        "params": param_specs,
        "m": tree_map(moment, param_specs),
        "v": tree_map(moment, param_specs),
    }


def init_state(params, tcfg: TrainConfig):
    mdt = moment_dtype(tcfg)
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "params": params,
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
    }


def quantize_int8(g, noise):
    """Stochastic-rounding int8 quantise -> dequantise of one leaf
    against its own scale (max |g| / 127), given ``noise`` uniform in
    [-0.5, 0.5) of g's shape."""
    gf = g.to(F32)
    scale = gf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(torch.int8)
    return q.to(F32) * scale


def compress_grads_int8(grads, generator: torch.Generator):
    """``quantize_int8`` on every leaf, its noise drawn from
    ``generator`` leaf by leaf in tree order."""
    def one(g):
        noise = torch.rand(g.shape, generator=generator, dtype=F32,
                           device=generator.device) - 0.5
        return quantize_int8(g, noise.to(g.device))

    return tree_map(one, grads)


@torch.no_grad()
def adamw_update(state, grads, tcfg: TrainConfig):
    """One AdamW step on ``state`` with ``grads`` (a tree of the params'
    structure), in place.  With ``grad_compression="int8"`` the noise
    comes from a generator seeded from ``tcfg.seed`` and the step (which
    reads the step back from the device).  Returns (state, {"lr",
    "grad_norm"})."""
    state["step"] += 1
    step = state["step"]
    lr = lr_schedule(tcfg, step)
    if tcfg.grad_compression == "int8":
        grads = compress_grads_int8(grads, torch.Generator(
            device=step.device).manual_seed(tcfg.seed * 1_000_003 + int(step)))
    gnorm = global_norm(grads)
    clip = (torch.clamp(tcfg.grad_clip / gnorm.clamp_min(1e-12), max=1.0)
            if tcfg.grad_clip > 0 else 1.0)
    b1, b2, eps = tcfg.b1, tcfg.b2, tcfg.eps
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)
    # m_new = b1 m + (1 - b1) g, v_new = b2 v + (1 - b2) g g,
    # p -= lr (m_new / bc1 / (sqrt(v_new / bc2) + eps) + wd p): each
    # operation in the reference's order, in place where it can be (the
    # same roundings, a leaf's worth of temporaries fewer)
    for p, g, m, v in zip(tree_leaves(state["params"]), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.to(F32) * clip
        m32 = m.to(F32).mul_(b1).add_((1 - b1) * g)
        v32 = v.to(F32).mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
        if tcfg.weight_decay > 0 and p.ndim >= 2:   # no decay on vectors
            delta.add_(tcfg.weight_decay * p.to(F32))
        p.copy_(p.to(F32).sub_(delta.mul_(lr)))
        m.copy_(m32)
        v.copy_(v32)
    return state, {"lr": lr, "grad_norm": gnorm}

