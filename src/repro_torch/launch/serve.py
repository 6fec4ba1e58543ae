"""Serving launcher: serve any ``--arch`` the port has, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --requests 3 --max-new 16          # published widths, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu               # CPU-sized smoke config

Families with a paged-KV layout (dense/vlm, and the non-MLA moe stage)
stream through the continuous-batching scheduler (``lm_scheduler``):
internvl2-1b, tinyllama-1.1b, llama3-8b, llama3-405b, gemma2-9b (its
local layers windowed in prefill and in paged decode) and
granite-moe-3b-a800m.  The recurrent families (hybrid zamba2, ssm
xLSTM), MLA's latent cache (deepseek-v3-671b) and the encoder-decoder
family (whisper, whose requests carry their audio frames) have no paged
layout: each request runs its solo prefill and dense-cache decode
through ``Deployment.submit()`` of a head-only generative model.  ``--plan``
prints the S2M3 deployment plan for the arch over the paper's edge
testbed (placement, memory ledger, predicted latency) instead.

``serve_arch`` is the same path as a function: arch config, requests
and device in; results and kernel launch counts out.  Weights are
random, drawn on the device from seed 0, as the reference draws them
from ``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.common.config import get_config, list_archs
from repro_torch.common.device import resolve_device
from repro_torch.core.routing import Request
from repro_torch.kernels import ops as kops


@dataclass
class ServeRun:
    results: list            # InferenceResult per request, in request order
    launches: dict[str, int]  # kernel launches while serving, by kernel
    seconds: float           # wall time of serving, device work included
    decode_steps: int        # decode steps (batched ticks, or solo steps)
    engine: Any              # serving.engine.S2M3Engine holding the model
    scheduler: Any = None    # the ServeScheduler of a paged run (its trace
    #                          and stats), None for the solo path


def plan_s2m3(cfg, routing: str):
    """Where would this arch live on the paper's testbed, and how fast
    would a request be?  One facade chain answers both."""
    from repro_torch.core.module import distinct_modules
    from repro_torch.core.profiles import install_profile, make_testbed
    from repro_torch.core.zoo import arch_model_spec, request_for
    from repro_torch.s2m3 import Deployment

    spec = arch_model_spec(cfg)
    cluster = make_testbed(with_server=True)
    install_profile(cluster, distinct_modules([spec]).values())
    dep = (Deployment(cluster)
           .add_model(spec)
           .plan(placement="greedy", routing=routing, replicate=True))
    report = dep.simulate([request_for(spec, 0, "desktop")])
    print(f"[serve] S2M3 plan for {cfg.name}:")
    print(report.summary())
    return report


def make_requests(cfg, n: int, max_new: int, *, temperature: float = 0.0,
                  prompt_lens=None, seed: int = 0) -> list[Request]:
    """``n`` requests to the head-only model "lm", prompts drawn from
    ``seed`` (2-7 tokens unless ``prompt_lens`` gives each length); VLM
    requests carry a precomputed image prefix, encoder-decoder requests
    ``encoder_seq`` precomputed audio frames."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        inputs = {}
        if cfg.has_vision_stub:
            inputs["vision"] = 0.1 * rng.standard_normal(
                (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.is_encoder_decoder:
            inputs["audio"] = 0.1 * rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        size = rng.integers(2, 8) if prompt_lens is None else prompt_lens[i]
        prompt = tuple(rng.integers(1, cfg.vocab_size, size=size).tolist())
        reqs.append(Request(rid=i, model="lm", source="dev0", prompt=prompt,
                            max_new_tokens=max_new, temperature=temperature,
                            inputs=inputs or None))
    return reqs


def _memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def head_only_deployment(bundle, params, device):
    """A one-device ``Deployment`` of the bundle as the generative head
    of a head-only model "lm", planned and materialized on ``device``."""
    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.s2m3 import Deployment

    name = bundle.cfg.name
    kv = (bundle.kv_bytes_per_token()
          if bundle.paged_cache_specs is not None else 0)
    head = ModuleSpec(name, "head", "task", bundle.param_count(),
                      bytes_per_param=4.0, generative=True,
                      flops_per_query=2.0 * bundle.param_count(),
                      kv_bytes_per_token=kv)
    cluster = ClusterSpec(devices=[DeviceSpec("dev0", _memory_bytes(device),
                                              1e12)])
    return (Deployment(cluster)
            .add_model(ModelSpec("lm", "generation", (), head),
                       {name: lambda: (bundle, params)})
            .plan("greedy")
            .materialize(device=device))


def serve_arch(cfg, requests, *, device=None, params=None,
               max_batch: int = 4, cache_len: int = 256) -> ServeRun:
    """Build ``cfg``'s model on ``device`` (CUDA unless the caller names
    another), with ``params`` or random weights from seed 0, and serve
    ``requests``: through the paged scheduler where the family has a
    paged layout, else one ``Deployment.submit()`` per request."""
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import sync
    from repro_torch.serving.scheduler import SchedulerConfig, lm_scheduler

    device = resolve_device(device)
    bundle = build_model(cfg, compute_dtype=torch.float32)
    if params is None:
        params = bundle.init(torch.Generator(device=device).manual_seed(0),
                             device=device)
    before = dict(kops.LAUNCHES)
    t0 = time.perf_counter()
    sched = None
    if bundle.supports_paged_decode:
        sched = lm_scheduler(bundle, params, device=device,
                             config=SchedulerConfig(
                                 decode_rows=max_batch, max_seq_len=cache_len,
                                 page_size=16,
                                 decode_pages=max_batch * -(-cache_len // 16) + 1))
        results = sched.serve(requests)
        steps = sched.stats_dict()[cfg.name]["decode_steps"]
        engine = sched.engine
    else:
        dep = head_only_deployment(bundle, params, device)
        results = [dep.submit(r) for r in requests]
        steps = sum(len(r.output) - 1 for r in results)
        engine = dep.engine
    sync(device)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kops.LAUNCHES.items()}
    return ServeRun(results, launches, seconds, steps, engine, sched)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-1b",
                    help=f"one of {', '.join(list_archs())}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--plan", action="store_true",
                    help="print the S2M3 placement plan and exit")
    ap.add_argument("--routing", default="queue_aware",
                    help="routing policy for --plan (paper | queue_aware)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.plan:
        plan_s2m3(cfg, args.routing)
        return
    reqs = make_requests(cfg, args.requests, args.max_new,
                         temperature=args.temperature)
    run = serve_arch(cfg, reqs, device=args.device,
                     max_batch=args.max_batch, cache_len=args.cache_len)
    rt = next(iter(run.engine.decoders.values()))
    print(f"[serve] {cfg.name} params={rt.bundle.param_count():,} on "
          f"{rt.device}")
    for r in run.results[:4]:
        toks = [int(t) for t in r.output[:12]]
        print(f"  req {r.rid}: {toks}{'...' if len(r.output) > 12 else ''}")
    total = sum(len(r.output) for r in run.results)
    print(f"[serve] {len(run.results)} requests, {total} tokens in "
          f"{run.seconds:.2f}s ({total / run.seconds:.1f} tok/s, "
          f"{run.decode_steps} decode steps)")
    print(f"[serve] kernel launches: "
          f"{ {k: v for k, v in run.launches.items() if v} }")


if __name__ == "__main__":
    main()
