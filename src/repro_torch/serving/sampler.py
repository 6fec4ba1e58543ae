"""Token samplers.

The dispatch between greedy and stochastic sampling is explicit:
``greedy`` takes no generator, ``sample`` requires one and rejects
``temperature <= 0``.  ``select_token`` is the serving entry point.
Where the JAX package draws from ``jax.random.PRNGKey(rid)``, the port
draws from a ``torch.Generator`` seeded from the rid (``rid_generator``)
on the logits' device, so a sampled step keeps its logits there: the
same (generator state, temperature) always yields the same token, but
the tokens differ from JAX's draws.
"""

from __future__ import annotations

import torch


def rid_generator(rid: int | None, device) -> torch.Generator:
    """The per-request sampling stream on ``device`` (seeded as the
    reference seeds its PRNG key: ``rid & 0x7FFFFFFF``)."""
    return torch.Generator(device=device).manual_seed((rid or 0) & 0x7FFFFFFF)


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits, generator, *, temperature: float = 1.0, top_k: int = 0):
    if temperature <= 0.0:
        raise ValueError(
            "sample() requires temperature > 0; use greedy() (or "
            "select_token(), which dispatches explicitly) for "
            "deterministic decoding")
    if generator is None:
        raise ValueError("sample() requires a generator")
    logits = logits.float() / temperature
    if top_k > 0:
        vals, _ = torch.topk(logits, top_k, dim=-1)
        logits = torch.where(logits < vals[..., -1:],
                             torch.full_like(logits, float("-inf")), logits)
    # Gumbel-max, as jax.random.categorical draws
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def select_token(logits, generator=None, *, temperature: float = 0.0,
                 top_k: int = 0):
    """Explicit greedy/stochastic dispatch: ``temperature <= 0`` is
    greedy (generator unused, may be None); otherwise ``generator`` is
    required."""
    if temperature <= 0.0:
        return greedy(logits)
    return sample(logits, generator, temperature=temperature, top_k=top_k)
