"""What every configuration's builder (``configs/<name>.py``) shares.

A builder defines ``Bench(sizes, mix, seed, device)``, a subclass of
``BaseBench`` that, on construction, draws its weights on the device
from the seed, admits its tasks to an ``s2m3.Deployment`` of the port,
plans and materializes it, and draws its input pool.  It then answers
the harness: ``request(spec)`` (the ``Request`` a traffic spec stands
for), ``warm_groups()``, ``keep(result)`` (what the check needs of a
finished request), ``call_work(call)`` (a device call's work, for the
metrics) and ``check(kept, finished, seed)`` (the compared numbers,
after ``release()``).
"""

from __future__ import annotations

import gc

import torch

from portbench.weights import sub_seed


class BaseBench:
    def __init__(self, sizes: dict, mix: dict, seed: int, device):
        self.sizes = sizes
        self.mix = mix
        self.seed = seed
        self.device = torch.device(device)
        self.dep = None
        self.sched = None

    # -- the program ----------------------------------------------------
    def scheduler(self):
        """The scheduler ``Deployment.serve()`` would build for the mix's
        ``scheduler`` settings, after the same pre-flight."""
        from repro_torch.analysis.diagnostics import PlanError, errors
        from repro_torch.serving.scheduler import (SchedulerConfig,
                                                   ServeScheduler)

        cfg = SchedulerConfig(**self.mix.get("scheduler", {}))
        errs = errors(self.dep.verify(decode_pages=cfg.decode_pages,
                                      page_size=cfg.page_size))
        if errs:
            raise PlanError("serve pre-flight: "
                            + "; ".join(d.format() for d in errs),
                            diagnostics=errs)
        self.sched = ServeScheduler(self.dep.engine, config=cfg)
        self.dep.scheduler = self.sched
        return self.sched

    def release(self) -> None:
        """Free the program's state (weights, caches, scheduler)."""
        self.dep = self.sched = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_info(self, peak: int) -> dict:
        if self.device.type == "cuda":
            return {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(self.device),
                    "count": 1, "memory_peak_bytes": int(peak)}
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}

    def generator(self, stream: str) -> torch.Generator:
        """A generator on the device for one named stream of the seed."""
        return torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, stream))


def same_shapes(tree, specs, where="") -> None:
    """Raise unless the drawn ``tree`` has the port's spec tree's keys
    and shapes: the weights are handed over in the program's layout."""
    if isinstance(specs, dict):
        if set(tree) != set(specs):
            raise ValueError(f"{where}: keys {sorted(tree)} != the port's "
                             f"{sorted(specs)}")
        for k in specs:
            same_shapes(tree[k], specs[k], f"{where}/{k}")
    elif tuple(tree.shape) != tuple(specs.shape):
        raise ValueError(f"{where}: {tuple(tree.shape)} != the port's "
                         f"{tuple(specs.shape)}")
