"""Matrix products at the reference's precision or at the control's.

``"float32"`` is the configurations' stated precision: float32 products
with TF32 off.  ``"tf32"`` is the nearest precision below it, the
control: both operands of every product rounded to TF32 (10 mantissa
bits, round to nearest even) and the products summed in float32, as the
tensor cores do with TF32 on.  Rounding in software gives the same
control on the card and on the CPU.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32's 10 mantissa bits (nearest, ties to
    even); finite values only."""
    i = x.float().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + lsb, -8192)
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a.float(), b.float())


def attention(q, k, v, *, causal: bool, precision: str):
    """q (B, S, H, D), k/v (B, T, K, D) with H = K * G; softmax in
    float32 with the 1/sqrt(D) scale; causal masks key j > query i."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, *, D)
    scores = mm(qh, kh.transpose(-1, -2), precision) / D ** 0.5
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return mm(probs, vh, precision).transpose(1, 2)       # (B, S, H, D)
