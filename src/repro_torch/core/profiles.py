"""Paper-testbed calibration (Tables III, V, VI, VII).

The paper's edge testbed is not at hand, so ``t_comp`` is a calibrated
model:
per-module FLOPs (2·N·tokens) divided by per-device *effective* speeds,
fitted to the paper's own end-to-end anchors:

  anchor (paper)                               value   source
  ------------------------------------------  ------  ---------
  CLIP ViT-B/16 centralized on server (GPU)    2.44 s  Table VII
  ... on desktop                               3.46 s  Table VII
  ... on laptop                                3.02 s  Table VII
  ... on server w/o GPU                        6.70 s  Table VII
  ... on Jetson Nano                          45.19 s  Table VII
  LLaVA-class head on server                  ~1.5 s   Table XI

Effective speeds fold in the unoptimized single-image PyTorch pipeline
the paper measures (they are far below peak FLOP/s — intentionally).
LLM heads get a kind-multiplier because autoregressive serving stacks
are much better optimized per FLOP than single-image vision pipelines.
Memory numbers are exact (param counts are published); latency
reproduces the paper's *trends* and is reported with deltas in
EXPERIMENTS.md.
"""

from __future__ import annotations

from repro_torch.core.cluster import ClusterSpec, DeviceSpec

GB = 1024**3

# tokens per query by modality — drives flops_per_query = 2 * N * tokens
TOKENS_PER_QUERY = {
    "vision": 197,     # ViT-B/16 grid + CLS
    "text": 20,
    "audio": 500,
    "task": 30,        # LLM head: generated tokens per answer
}

# per-module-kind speed multiplier (serving-stack efficiency).  Text
# encoders run short sequences (overhead-bound: 1/3 the per-FLOP rate);
# LLM heads generate ~30 tokens through heavily-optimized decoder stacks
# (~3x the single-image vision pipeline's per-FLOP rate).
KIND_SPEED = {
    "vision": 1.0,
    "text": 0.33,
    "audio": 1.0,
    "task": 3.0,
}

# Retrieval requests carry ~100 candidate class prompts (zero-shot
# classification over the benchmark label set) — this is why the paper's
# text encoder dominates retrieval latency (footnote 2: 3 s laptop / 43 s
# Jetson) while encoder-only VQA with ONE question is 10x faster on the
# same modules (Table VI).  The multiplicity lives on the REQUEST
# (core.routing.Request.work), not the module — shared modules keep one
# signature.  Per-device marginal cost of the extra prompts is
# DeviceSpec.extra_work_factor (rho): batched backends amortize
# (rho=0.24); the 4 GB Jetson is super-linear (rho=1.47, memory thrash).
RETRIEVAL_TEXT_QUERIES = 100

# (speed, rho) jointly fitted to THREE anchor families:
#   retrieval centralized per device (Table VII: 2.44/6.70/3.46/3.02/45.19),
#   encoder-only VQA-S (Table VI: server 1.23, jetson 6.28),
#   the parallel-processing saving (Table VII: 3.03-2.48 = 0.55 s =
#   ViT-B/16 vision time on the desktop).
# Resulting closed-form predictions: S2M3 2.45 (paper 2.48), no-parallel
# 2.99 (3.03), VQA-S S2M3 0.62 (0.50) — see EXPERIMENTS.md.
EFFECTIVE_SPEED = {
    "server": 31.4e9,
    "server-nogpu": 11.4e9,
    "desktop": 61.8e9,
    "laptop": 54.8e9,
    "jetson-a": 6.15e9,
    "jetson-b": 6.15e9,
}

EXTRA_WORK_FACTOR = {
    "server": 0.083,
    "server-nogpu": 0.083,
    "desktop": 0.384,
    "laptop": 0.278,
    "jetson-a": 0.525,
    "jetson-b": 0.525,
}

# memory available for fp32 module weights (Table III).  The Jetson's
# effective budget is fitted to the paper's own feasibility boundary
# (Table VI '—' rows): CLIP RN50x4 (584 MB fp32) runs, RN50x16 (1.01 GB)
# does not — the 4 GB board keeps ~3 GB for OS + runtime + activations.
MEM_CAPACITY = {
    "server": int(23.9 * GB),
    "server-nogpu": int(33.7 * GB),
    "desktop": int(28.0 * GB),
    "laptop": int(14.0 * GB),
    "jetson-a": int(0.8 * GB),
    "jetson-b": int(0.8 * GB),
}

# model load+download time per GB (footnote 1: CLIP ViT-B/16 ≈ 20.44 s
# for 0.6 GB of fp32 weights -> ~34 s/GB on the testbed)
LOAD_SECONDS_PER_GB = 34.0


def make_testbed(*, with_server: bool = False, server_gpu: bool = True
                 ) -> ClusterSpec:
    """The paper's 4-device PAN (+ optional MAN server)."""
    def _dev(name, kind="edge"):
        return DeviceSpec(name, MEM_CAPACITY[name], EFFECTIVE_SPEED[name],
                          kind=kind,
                          extra_work_factor=EXTRA_WORK_FACTOR[name])

    devices = [_dev("desktop"), _dev("laptop"), _dev("jetson-a"),
               _dev("jetson-b")]
    links = {}
    if with_server:
        name = "server" if server_gpu else "server-nogpu"
        devices.append(_dev(name, kind="server"))
        for d in ("desktop", "laptop", "jetson-a", "jetson-b"):
            # MAN link: dedicated server, 4-5 ms per packet (paper §VI)
            links[(d, name)] = (25e6, 0.0045)
    return ClusterSpec(
        devices=devices,
        links=links,
        default_bandwidth=12.5e6,   # 100 Mbps home Wi-Fi/wired mix
        default_latency=0.005,
    )


def effective_t_comp(module, device: DeviceSpec) -> float:
    mult = KIND_SPEED.get(module.modality, 1.0)
    if module.flops_per_query <= 0:
        return 1e-4
    return module.flops_per_query / (device.compute_speed * mult)


def install_profile(cluster: ClusterSpec, modules) -> ClusterSpec:
    """Precompute the (module, device) comp table with kind multipliers."""
    for m in modules:
        for d in cluster.devices:
            cluster.comp_table[(m.name, d.name)] = effective_t_comp(m, d)
    return cluster


def load_time(module, device: DeviceSpec) -> float:
    """End-to-end adds module download+load (footnote 1)."""
    return module.mem_bytes / GB * LOAD_SECONDS_PER_GB
