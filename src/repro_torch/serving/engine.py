"""S2M3 multi-task serving engine (real computation).

Brings the paper's architecture to life on a CUDA device (or, when the
caller asks for it, the CPU):

* one ``ModuleRuntime`` per *distinct* module signature — the
  ``ModuleRegistry`` guarantees a model added later reuses already-
  deployed modules (weights exist once per signature, §IV-B);
* modules live on the device chosen by ``core.placement``; placement
  hosts are logical names mapped onto ``torch.device``s (several hosts
  may share one card), and request inputs move there with ``.to()``;
* per-request parallel routing: encoder calls are launched on the
  current stream without waiting (CUDA launches are asynchronous), so
  the host only waits where it reads a result back (§V, Eq. 2-3).

There is no ``jit``: modules run eagerly.  Where the JAX package
donates cache buffers to a jitted step, the port's model functions
update the caches in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.device import resolve_device  # noqa: F401  (re-export)
from repro_torch.common.pytree import tree_map
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.core.placement import Placement
from repro_torch.core.registry import ModuleRegistry
from repro_torch.obs.trace import Span, Tracer


def to_device(tree, device):
    """Move every leaf (tensor or array) of a tree to ``device`` — the
    port's ``jax.device_put``; a tensor already there is not copied."""
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (the port's
    ``block_until_ready``): spans and latencies then measure the device
    work, not just its launch.  A no-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ModuleRuntime:
    spec: ModuleSpec
    apply: Callable              # (params, *inputs) -> output
    params: Any
    device: torch.device
    host: str | None = None      # placement device name (routing identity)
    # lazily materialized replica params, host -> device-resident copy.
    # Populated only when routing actually sends traffic to another of
    # the module's placement hosts (see S2M3Engine.params_on).
    replicas: dict[str, Any] = dataclasses.field(default_factory=dict)


#: modality -> prefill batch key for decoder extras (how encoder outputs
#: reach a generative head's prefill, e.g. a vision encoder's embedding
#: becoming the VLM decoder's image prefix)
EXTRA_KEYS = {"vision": "image_embeds", "audio": "audio_frames"}


@dataclasses.dataclass
class DecoderRuntime:
    """A generative head module: a ModelBundle (prefill / decode_step /
    paged_decode_step) pinned to one host — its paged KV cache lives
    there, so unlike stateless encoders it is not freely re-routable
    mid-stream."""

    spec: ModuleSpec
    bundle: Any
    params: Any
    device: torch.device
    host: str | None = None

    @property
    def n_prefix(self) -> int:
        cfg = self.bundle.cfg
        return cfg.n_image_tokens if cfg.has_vision_stub else 0


@dataclasses.dataclass
class InferenceResult:
    model: str
    output: Any
    encoder_outputs: dict[str, Any]
    # obs.trace spans, one per module phase; each still unpacks as the
    # legacy (module, phase, t0, t1) tuple
    timeline: list[Span]
    latency_s: float
    # placement device name each module ran on — comparable with the
    # simulator's per-request routes (s2m3.PlanReport.routes)
    devices: dict[str, str] = dataclasses.field(default_factory=dict)
    rid: int | None = None


class S2M3Engine:
    def __init__(self, device_map: dict[str, Any] | None = None, *,
                 registry: ModuleRegistry | None = None,
                 cluster=None, routing: str = "paper",
                 tracer: Tracer | None = None):
        """device_map: placement device name -> torch.device.  Defaults
        to {"dev0": cuda} (raising without a CUDA device).  When ``cluster`` is
        given, replica choice among a module's placement hosts goes
        through the named routing policy instead of first-host."""
        self.registry = registry or ModuleRegistry()
        # solo infer()/generate() spans land here; the serving scheduler
        # uses its own epoch-relative tracer for the batched paths
        self.tracer = tracer or Tracer()
        self.runtimes: dict[str, ModuleRuntime] = {}
        self.decoders: dict[str, DecoderRuntime] = {}
        self.device_map = device_map or {"dev0": resolve_device()}
        self.placement: Placement | None = None
        self.cluster = cluster
        self.routing = routing
        # optional live queue probe (set by serving.scheduler): () ->
        # core.routing.QueueSnapshot.  When attached, routing decisions
        # consult real per-device occupancy instead of an empty queue.
        self.queue_probe: Callable[[], Any] | None = None

    # -- deployment -----------------------------------------------------
    def deploy_model(
        self,
        model: ModelSpec,
        builders: dict[str, Callable[[], tuple[Callable, Any]]],
        placement: Placement | None = None,
    ) -> list[str]:
        """Register a model; build runtimes only for newly needed modules.

        builders: module signature -> () -> (apply_fn, params).
        Returns names of modules actually loaded (sharing = short list).
        """
        self.registry.add_model(model)
        if placement is not None:
            self.placement = placement
        loaded = []
        for m in model.modules:
            if m.name in self.runtimes or m.name in self.decoders:
                continue                      # shared module already live
            apply_or_bundle, params = builders[m.name]()
            host = self._host_for(m.name)
            dev = self._device_for(host)
            params = to_device(params, dev)
            if hasattr(apply_or_bundle, "decode_step"):
                # generative head: the builder returned a ModelBundle
                self.decoders[m.name] = DecoderRuntime(
                    m, apply_or_bundle, params, dev, host)
            else:
                self.runtimes[m.name] = ModuleRuntime(
                    m, apply_or_bundle, params, dev, host)
            loaded.append(m.name)
        return loaded

    def evict_model(self, name: str) -> list[str]:
        freed = self.registry.remove_model(name)
        for m in freed:
            self.runtimes.pop(m.name, None)
            self.decoders.pop(m.name, None)
        return [m.name for m in freed]

    def migrate(self, module_name: str, host: str) -> None:
        """Move a live module's weights to another placement device
        (replan execution: the paper's dynamic-network migration)."""
        rt = self.runtimes.get(module_name)
        if rt is None or host not in self.device_map:
            return
        dev = self.device_map[host]
        cached = rt.replicas.pop(host, None)
        rt.params = cached if cached is not None else \
            to_device(rt.params, dev)
        rt.device, rt.host = dev, host

    def module_hosts(self, module_name: str) -> list[str]:
        """Placement hosts for a module that the engine can actually
        execute on (i.e. present in ``device_map``).  Raises when the
        placement names hosts but none is mapped — previously the engine
        silently ran on an arbitrary device while reporting the unmapped
        host, so real and reported routes diverged."""
        if self.placement is None:
            return []
        hosts = self.placement.devices_for(module_name)
        mapped = [h for h in hosts if h in self.device_map]
        if hosts and not mapped:
            from repro_torch.analysis.diagnostics import PlanError

            raise PlanError(
                f"module {module_name!r} is placed on {list(hosts)} but none "
                f"of those hosts is in device_map {sorted(self.device_map)}; "
                "extend device_map (see Deployment._extend_device_map) or "
                "replan onto mapped devices",
                module=module_name, requested=tuple(hosts),
                available=tuple(sorted(self.device_map)))
        return mapped

    def route_module(self, module_name: str, *, device_free=None,
                     ready_time: float = 0.0, source: str | None = None,
                     request=None) -> str | None:
        """Choose the executing host for one module call.  Replicated
        modules go through the named routing policy; callers holding
        live queue state (the serving scheduler) pass it in, otherwise
        the engine's attached ``queue_probe`` — if any — supplies it, so
        ``queue_aware`` ranks hosts by real occupancy rather than the
        empty deploy-time queue."""
        hosts = self.module_hosts(module_name)
        if not hosts:
            return None
        if len(hosts) > 1 and self.cluster is not None:
            from repro_torch.s2m3.policies import RouteQuery, get_routing

            if device_free is None and self.queue_probe is not None:
                snap = self.queue_probe()
                device_free = snap.free_map()
                ready_time = max(ready_time, snap.t)
            mod = self.registry.modules.get(module_name)
            if mod is not None:
                return get_routing(self.routing)(RouteQuery(
                    module=mod, hosts=tuple(hosts), cluster=self.cluster,
                    source=source, request=request, ready_time=ready_time,
                    device_free=device_free or {}))
        return hosts[0]

    def _host_for(self, module_name: str) -> str | None:
        """Deploy-time host choice (empty-queue tie-break = the
        simulator's choice for a fresh request, unless a live scheduler
        probe is attached)."""
        return self.route_module(module_name)

    def _device_for(self, host: str | None):
        if host is not None and host in self.device_map:
            return self.device_map[host]
        return next(iter(self.device_map.values()))

    def params_on(self, module_name: str, host: str | None):
        """Device-resident params for a module call routed to ``host``.
        The primary copy lives on ``rt.host``; other placement hosts get
        a lazily cached replica (weights still exist once per signature
        per device)."""
        rt = self.runtimes[module_name]
        if host is None or host == rt.host or host not in self.device_map:
            return rt.params
        if host not in rt.replicas:
            rt.replicas[host] = to_device(rt.params, self.device_map[host])
        return rt.replicas[host]

    # -- batched-apply path (serving.scheduler) -------------------------
    def apply_module(self, module_name: str, x: Any, *,
                     host: str | None = None) -> tuple[Any, str | None]:
        """Run one (possibly batched) module call on ``host`` without
        waiting — CUDA launches are asynchronous; callers wait when they
        read the output back.  Returns (output, host_actually_used)."""
        rt = self.runtimes[module_name]
        used = host if host is not None and host in self.device_map else rt.host
        params = self.params_on(module_name, used)
        x = torch.as_tensor(x).to(self._device_for(used))
        return rt.apply(params, x), used

    def apply_head(self, module_name: str, enc_outputs: dict[str, Any],
                   head_extra: dict | None = None, *,
                   host: str | None = None) -> tuple[Any, str | None]:
        """Head call: encoder outputs (by modality) move to the head's
        device — the paper's encoder->head transfer."""
        rt = self.runtimes[module_name]
        used = host if host is not None and host in self.device_map else rt.host
        params = self.params_on(module_name, used)
        dev = self._device_for(used)
        moved = {k: torch.as_tensor(v).to(dev) for k, v in enc_outputs.items()}
        return rt.apply(params, moved, **(head_extra or {})), used

    # -- generative (decoder-head) path ---------------------------------
    def decoder_runtime(self, module_name: str) -> DecoderRuntime:
        rt = self.decoders.get(module_name)
        if rt is None:
            raise KeyError(
                f"module {module_name!r} has no decoder runtime; "
                "generative heads need a builder returning "
                "(ModelBundle, params)")
        return rt

    @staticmethod
    def gen_batch(prompt, enc_outputs: dict[str, Any]) -> dict[str, Any]:
        """Batch-1 prefill inputs for a generative head: prompt tokens
        plus encoder outputs mapped through ``EXTRA_KEYS`` (e.g. a
        vision encoder's embedding feeding the VLM image prefix)."""
        batch = {"tokens": torch.tensor([list(prompt)], dtype=torch.int32)}
        for modality, key in EXTRA_KEYS.items():
            if modality in enc_outputs:
                v = torch.as_tensor(enc_outputs[modality])
                batch[key] = v if v.ndim == 3 else v[None]
        return batch

    def init_paged_cache(self, module_name: str, n_pages: int,
                         page_size: int, dtype=None):
        rt = self.decoder_runtime(module_name)
        return rt.bundle.init_paged_cache(n_pages, page_size,
                                          dtype or torch.float32, rt.device)

    def apply_prefill(self, module_name: str, batch: dict[str, Any],
                      cache) -> tuple[Any, Any]:
        """Batch-1 prefill on the decoder's pinned host; returns
        (last-token logits, filled dense cache)."""
        rt = self.decoder_runtime(module_name)
        batch = to_device(batch, rt.device)
        return rt.bundle.prefill(rt.params, batch, cache)

    def apply_paged_decode(self, module_name: str, tokens, cache,
                           block_tables, lengths) -> tuple[Any, Any]:
        """One batched decode step over the paged KV cache, which is
        updated in place (and returned)."""
        rt = self.decoder_runtime(module_name)
        if rt.bundle.paged_decode_step is None:
            raise NotImplementedError(
                f"decoder {module_name!r} (family "
                f"{rt.bundle.cfg.family!r}) has no paged decode path")
        return rt.bundle.paged_decode_step(
            rt.params, tokens.to(rt.device), cache,
            block_tables.to(rt.device), lengths.to(rt.device))

    def generate(self, request) -> InferenceResult:
        """Solo generative inference: encoders run as in ``infer()``;
        the head prefills a batch-1 dense cache and decodes
        sequentially.  This is the single-sequence oracle the batched
        paged decode streams are compared against."""
        from repro_torch.serving.sampler import rid_generator, select_token

        model = self.registry.models[request.model]
        if request.prompt is None:
            raise ValueError(
                f"request {request.rid} targets generative model "
                f"{request.model!r} but has no prompt")
        rt = self.decoder_runtime(model.head.name)
        now = self.tracer.clock
        t_start = now()
        root = self.tracer.begin("request", "request", rid=request.rid,
                                 t0=t_start, model=request.model)
        timeline = []
        devices = {}
        # head-only models may carry precomputed modality features as
        # inputs (e.g. image embeds for a VLM without a deployed vision
        # encoder); live encoders overwrite their modality below
        enc_outputs: dict[str, Any] = dict(request.inputs or {})
        for enc in model.encoders:
            t0 = now()
            out, used = self.apply_module(enc.name, request.inputs[enc.modality])
            sync(out.device)
            timeline.append(self.tracer.record(
                enc.name, "encode", t0, now(), rid=request.rid,
                parent=root, host=used))
            enc_outputs[enc.modality] = out
            if used:
                devices[enc.name] = used
        if rt.host:
            devices[model.head.name] = rt.host

        prompt = list(request.prompt)
        max_new = max(int(request.max_new_tokens), 1)
        total = rt.n_prefix + len(prompt) + max_new + 1
        T = -(-total // 8) * 8
        cache = rt.bundle.init_cache(1, T, torch.float32, rt.device)
        t0 = now()
        logits, cache = self.apply_prefill(
            model.head.name, self.gen_batch(prompt, enc_outputs), cache)
        sync(logits.device)
        timeline.append(self.tracer.record(
            model.head.name, "prefill", t0, now(), rid=request.rid,
            parent=root, prompt_tokens=len(prompt)))

        gen = rid_generator(request.rid, logits.device)
        toks = [int(select_token(logits[0], gen,
                                 temperature=request.temperature))]
        L = rt.n_prefix + len(prompt)
        t0 = now()
        while (len(toks) < max_new and toks[-1] != request.eos_id
               and L < T - 1):
            logits, cache = rt.bundle.decode_step(
                rt.params,
                torch.tensor([[toks[-1]]], dtype=torch.int32, device=rt.device),
                cache, torch.tensor([L], dtype=torch.int32, device=rt.device))
            L += 1
            toks.append(int(select_token(logits[0], gen,
                                         temperature=request.temperature)))
        timeline.append(self.tracer.record(
            model.head.name, "decode", t0, now(), rid=request.rid,
            parent=root, new_tokens=len(toks)))
        t_end = now()
        self.tracer.end(root, t1=t_end)
        return InferenceResult(
            model=request.model, output=np.asarray(toks, np.int32),
            encoder_outputs=enc_outputs, timeline=timeline,
            latency_s=t_end - t_start, devices=devices,
            rid=request.rid)

    # -- inference ------------------------------------------------------
    def infer(self, model_name: str, inputs: dict[str, Any],
              head_extra: dict | None = None,
              rid: int | None = None) -> InferenceResult:
        """inputs: modality -> array for each encoder; head receives the
        dict of encoder outputs (by modality) plus head_extra kwargs."""
        model = self.registry.models[model_name]
        if model.head.name in self.decoders:
            raise ValueError(
                f"model {model_name!r} has a generative head; use "
                "generate(request) for solo inference or the serving "
                "scheduler for batched decode")
        now = self.tracer.clock
        t_start = now()
        root = self.tracer.begin("request", "request", rid=rid,
                                 t0=t_start, model=model_name)
        timeline = []
        devices = {m.name: rt.host for m in model.modules
                   if (rt := self.runtimes.get(m.name)) and rt.host}

        # launch all encoders without waiting (asynchronous CUDA
        # launches); apply_module moves the payload to the hosting device
        pending: dict[str, Any] = {}
        for enc in model.encoders:
            t0 = now()
            out, used = self.apply_module(enc.name, inputs[enc.modality])
            pending[enc.modality] = (enc.name, out, t0)
            if used:
                devices[enc.name] = used

        enc_outputs = {}
        for modality, (name, out, t0) in pending.items():
            sync(out.device)
            timeline.append(self.tracer.record(
                name, "encode", t0, now(), rid=rid, parent=root,
                host=devices.get(name)))
            enc_outputs[modality] = out

        t0 = now()
        result, used = self.apply_head(model.head.name, enc_outputs,
                                       head_extra)
        sync(result.device)
        timeline.append(self.tracer.record(
            model.head.name, "head", t0, now(), rid=rid, parent=root,
            host=used))
        if used:
            devices[model.head.name] = used

        t_end = now()
        self.tracer.end(root, t1=t_end)
        return InferenceResult(
            model=model_name, output=result, encoder_outputs=enc_outputs,
            timeline=timeline, latency_s=t_end - t_start,
            devices=devices, rid=rid)

    # -- stats ----------------------------------------------------------
    def deployed_bytes(self) -> int:
        return self.registry.shared_bytes()

    def dedicated_bytes(self) -> int:
        return self.registry.dedicated_bytes()
