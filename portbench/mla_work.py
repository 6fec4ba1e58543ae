"""The yardstick's arithmetic for DeepSeek-V3's blocks, frozen beside
``work.py`` (which stays as it is): the work a call of MLA's absorbed
paged decode kernel must do, and the model FLOPs of MLA and MoE blocks.

Nothing here imports the program.  The kernel's work counts, per live
row and layer, the scores of every head against each live key's latent
and rotary parts and the weighted sum of the latents,
``2 H keys (r + rope + r)`` FLOPs, and its bytes: each live key's
``r + rope`` floats read once, each row's query (``r + rope`` a head)
read once and its output (``r`` a head) written once, the table entries
of the pages the keys lie in and the lengths.
"""

from __future__ import annotations

from portbench.work import gemm_flops


def paged_mla_work(rows: int, H: int, r: int, rope: int, page_size: int,
                   keys, isz: int = 4) -> tuple[int, float]:
    """(bytes, FLOPs) of one paged MLA decode call over a batch of
    ``rows`` rows of which ``keys`` lists the live ones' key counts."""
    live = sum(int(n) for n in keys)
    pages = sum(-(-int(n) // page_size) for n in keys)
    nbytes = (live * (r + rope) * isz + rows * H * (2 * r + rope) * isz
              + 4 * pages + 4 * rows)
    return nbytes, 2.0 * H * live * (2 * r + rope)


def mla_proj_flops(tokens: int, d: int, H: int, q_rank: int, kv_rank: int,
                   nope: int, rope: int, v: int) -> float:
    """An MLA block's projections over ``tokens`` positions: the query's
    low-rank pair, the latent and rotary key, each head's latent to
    ``nope`` keys and ``v`` values (prefill rebuilds them, decode folds
    them into the query and after the attention: the same products a
    token), the output."""
    return (gemm_flops(tokens, d, q_rank)
            + gemm_flops(tokens, q_rank, H * (nope + rope))
            + gemm_flops(tokens, d, kv_rank + rope)
            + gemm_flops(tokens, kv_rank, H * (nope + v))
            + gemm_flops(tokens, H * v, d))


def mla_pair_flops(pairs: float, H: int, nope: int, rope: int,
                   v: int) -> float:
    """Prefill's attention over ``pairs`` query-key pairs of every head:
    the scores over nope + rope and the values' sum."""
    return 2.0 * H * pairs * (nope + rope + v)


def moe_flops(tokens: int, pairs: int, d: int, f: int, router: int,
              shared: int) -> float:
    """A MoE block's router over every token, the ``pairs`` routed
    (token, expert) pairs' SwiGLU FFNs and the shared experts' over every
    token."""
    return (gemm_flops(tokens, d, router)
            + 3 * gemm_flops(pairs, d, f)
            + 3 * shared * gemm_flops(tokens, d, f))
