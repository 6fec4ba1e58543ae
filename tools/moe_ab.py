#!/usr/bin/env python3
"""Same-call A/B of the dense MoE's two forms at granite-moe-3b-a800m's
full width and depth, on one NVIDIA GPU.

    python3 tools/moe_ab.py [--turns 2]

From the root of a checkout, on a machine with the card and ``nvcc``.
Both forms compute the reference's dense oracle (every expert on every
token, combined with the top-k gates):

* ``matmul``, the port's ``layers.moe.moe_apply_dense``: ``(T, D) @
  (E, D, f)`` broadcast to one batched product that reads each expert's
  weights in place;
* ``einsum``: the reference's ``einsum("td,edf->etf")`` and
  ``einsum("etf,efd->etd")`` written literally (``einsum_form`` below).

One model (random float32 weights from seed 0) is built once and serves
``chip_smoke.py`` phase 8's granite requests with each form in turns
(matmul, einsum, matmul, einsum, ... after one unrecorded warm-up):
serve() through the paged scheduler, then submit() of each request.
Each turn prints serve() tokens/s and ms per tick, solo tokens/s, wall
ms per dense decode step (B = 1, 10 steps), and over 3 decode steps the
summed device time under ``torch.profiler`` with its heaviest kernels.
Before the turns, the two forms' max |dlogit| on one prefill.  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def einsum_form(params, x, cfg):
    """The dense MoE as the reference writes it: two einsums per expert
    product (each lays the expert weights out anew)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.layers.mlp import activation, mlp_apply
    from repro_torch.layers.moe import _route, padded_experts

    B, S, D = x.shape
    E = padded_experts(cfg)
    tokens = x.reshape(-1, D)
    gates, idx, aux = _route(tokens, params["router"], cfg)
    comb = (F.one_hot(idx, E).float() * gates[..., None]).sum(dim=1)
    act = activation(cfg.act_fn)
    h_g = torch.einsum("td,edf->etf", tokens, params["wi_gate"].to(x.dtype))
    h_u = torch.einsum("td,edf->etf", tokens, params["wi_up"].to(x.dtype))
    y_e = torch.einsum("etf,efd->etd", act(h_g) * h_u,
                       params["wo"].to(x.dtype))
    y = torch.einsum("etd,te->td", y_e.float(), comb).to(x.dtype)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act_fn)
    return y, aux


def turn(cs, cfg, bundle, params, reqs, dev) -> str:
    """One serve() and submit() of ``reqs`` and a decode-step timing,
    with whichever form ``layers.moe`` holds now."""
    import torch

    from repro_torch.launch.serve import serve_arch

    run = serve_arch(cfg, reqs, device=dev, params=params,
                     max_batch=cs.FAM_ROWS, cache_len=cs.FAM_CACHE[cfg.name])
    trace = run.scheduler.tracer.trace
    ticks = {(sp.t0, sp.t1): sp.t1 - sp.t0 for r in reqs
             for sp in trace.spans_for(r.rid) if sp.phase == "decode_tick"}
    n_tok = run.scheduler.stats_dict()[cfg.name]["decode_tokens"]
    solo = [run.engine.generate(r) for r in reqs]
    torch.cuda.synchronize()
    solo_s = sum(sp.t1 - sp.t0 for r in solo for sp in r.timeline
                 if sp.phase == "decode")
    steps = sum(len(r.output) - 1 for r in solo)
    L0 = max(len(r.prompt) for r in reqs)
    batch = {"tokens": torch.tensor([max(reqs, key=lambda r: len(
        r.prompt)).prompt], dtype=torch.int32, device=dev)}
    _, cache = cs._prefill_ms(bundle, params, batch,
                              cs.dense_T(L0, cs.FAM_NEW), dev)
    tok = torch.tensor([[1]], dtype=torch.int32, device=dev)
    pos = torch.tensor([L0], dtype=torch.int32, device=dev)
    bundle.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        bundle.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    cs._profile_decode(cfg.name, bundle, params, cache, L0, dev)
    return (f"serve() {n_tok / sum(ticks.values()):.2f} tokens/s, "
            f"{1e3 * sum(ticks.values()) / len(ticks):.2f} ms per tick "
            f"({len(ticks)} ticks); solo {steps / solo_s:.2f} tokens/s; "
            f"dense decode step {step_ms:.2f} ms (wall, B = 1, 10 steps)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2,
                    help="rounds of (matmul, einsum) after the warm-up")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.config import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.layers import moe
    from repro_torch.models.api import build_model

    if not torch.cuda.is_available():
        print("moe_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"[card] {cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    cfg = get_config("granite-moe-3b-a800m")
    bundle = build_model(cfg, compute_dtype=torch.float32)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    lens = cs.prompt_lens(cs.FAM_PROMPTS, cs.FAM_REQS)
    reqs = make_requests(cfg, len(lens), cs.FAM_NEW, prompt_lens=lens,
                         seed=cs.SEED)
    forms = {"matmul": moe.moe_apply_dense, "einsum": einsum_form}
    logits = {}
    for name, fn in forms.items():
        moe.moe_apply_dense = fn
        logits[name] = cs._fresh_prefill(bundle, params,
                                         list(reqs[0].prompt), dev)
    print(f"[moe_ab] {cfg.name}: forms agree on a prefill of "
          f"{len(reqs[0].prompt)} tokens, max |dlogit| "
          f"{cs._err(logits['matmul'], logits['einsum']):.3e}", flush=True)
    moe.moe_apply_dense = forms["matmul"]
    turn(cs, cfg, bundle, params, reqs, dev)  # warm-up, not recorded
    for i in range(args.turns):
        for name, fn in forms.items():
            moe.moe_apply_dense = fn
            print(f"[moe_ab] turn {i} {name}: "
                  f"{turn(cs, cfg, bundle, params, reqs, dev)}", flush=True)
    moe.moe_apply_dense = forms["matmul"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
