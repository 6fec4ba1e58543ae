"""The yardstick's arithmetic, frozen: published peaks of one NVIDIA H100
SXM, the work a call of each attention kernel must do, and the model
FLOPs of the two configurations' steps.

Nothing here imports the program: the figures are copied from
``repro_torch/common/hw.py`` (NVIDIA's H100 SXM datasheet, dense rates)
and the kernel work from ``chip_smoke.py``'s ``_flash_work``,
``_live_keys`` and ``_paged_work``, so that a change to the program
cannot move the bounds it is measured against.  A kernel's work counts
each input byte read once and each output byte written once, and the
FLOPs of the query-key pairs its data makes live (4 D a pair and head:
Q.K^T and P.V).
"""

from __future__ import annotations

#: FLOP/s, dense, the FMA units (float32 without TF32)
PEAK_FLOPS_F32 = 67e12
#: FLOP/s, dense, bfloat16 on the tensor cores
PEAK_FLOPS_BF16 = 989e12
#: bytes/s of HBM3
HBM_BYTES_S = 3.35e12
#: device memory, bytes
HBM_BYTES = 80e9

PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}


def bound_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` on ``dtype`` inputs: the larger of the two."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])


def flash_work(B, S, T, H, K, D, causal, isz, window=0) -> tuple[int, float]:
    """A flash call's bytes (q, k, v, o) and FLOPs over the visible
    pairs: all S x T, or the causal triangle where S = T, less the keys a
    window hides (query i sees min(i + 1, window) keys)."""
    pairs = S * (S + 1) / 2 if causal else S * T
    if causal and 0 < window < S:
        pairs = window * (window + 1) / 2 + (S - window) * window
    return (2 * B * S * H * D + 2 * B * T * K * D) * isz, 4 * D * H * B * pairs


def live_keys(length: int, T: int, window: int = 0) -> tuple[int, int]:
    """A row's first live key and its live keys' count: [max(0, n -
    window), min(n, T)) under a window, [0, min(n, T)) without one."""
    end = min(max(length, 0), T)
    start = max(length - window, 0) if window else 0
    return start, max(end - start, 0)


def paged_work(rows: int, H: int, K: int, D: int, page_size: int,
               n_max: int, lengths, isz: int,
               window: int = 0) -> tuple[int, float]:
    """A paged decode call's bytes (q and o of every row of the batch,
    the live keys' k and v, the table entries of the pages they lie in,
    the lengths) and FLOPs over the live keys, for a batch of ``rows``
    rows of which ``lengths`` lists the live ones' key counts."""
    live = read = 0
    for n in lengths:
        start, cnt = live_keys(int(n), n_max * page_size, window)
        if cnt:
            live += cnt
            read += -(-(start + cnt) // page_size) - start // page_size
    nbytes = (2 * rows * H * D * isz + 2 * live * K * D * isz + 4 * read
              + 4 * rows)
    return nbytes, 4 * D * H * live


# --------------------------------------------------------------------------
# model FLOPs: 2 a multiply-add of each product; norms, activations and
# softmaxes are left out (they are not the card's FLOPs-bound work)
# --------------------------------------------------------------------------

def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attn_block_flops(tokens: int, d: int, H: int, K: int, hd: int,
                     d_ff: int, gated: bool) -> float:
    """One pre-norm transformer block's projections and MLP over
    ``tokens`` positions (attention's own products are counted apart)."""
    proj = gemm_flops(tokens, d, (H + 2 * K) * hd) + gemm_flops(
        tokens, H * hd, d)
    mlp = (3 if gated else 2) * gemm_flops(tokens, d, d_ff)
    return proj + mlp


def attn_pair_flops(pairs: float, H: int, hd: int) -> float:
    """Q.K^T and P.V over ``pairs`` query-key pairs of every head."""
    return 4.0 * hd * H * pairs
