"""The device's side of a ``--trace 1`` run, from ``torch.profiler``.

``start``/``stop`` bracket a slice of the window between two scheduler
steps (each of which ends synchronised with the card, so every kernel of
the slice's steps lies in it).  ``read`` reduces the profile to what the
metrics and the result's ``device`` and ``breakdown`` need: each device
operation (kernel, copy, set) as (name, start, end), the seconds in
which any of them ran (the union of their intervals), and the host's
top-level operation over each gap between them.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch


def start(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof) -> None:
    prof.__exit__(None, None, None)


@dataclass
class Slice:
    window_s: float                 # the slice's wall time (host clock)
    ops: list = field(default_factory=list)     # (name, t0 us, t1 us)
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)    # (host op, seconds)

    def device_seconds(self, match) -> float:
        """Summed time of the device operations whose name ``match``
        accepts."""
        return sum(t1 - t0 for n, t0, t1 in self.ops if match(n)) / 1e6

    def breakdown(self) -> dict:
        by_op: dict = {}
        for n, t0, t1 in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (t1 - t0) / 1e6
        by_gap: dict = {}
        for n, s in self.gaps:
            by_gap[n] = by_gap.get(n, 0.0) + s
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


def read(prof, window_s: float) -> Slice | None:
    """The slice, or None where the profiler saw no device operation."""
    dev_type = torch.autograd.DeviceType
    ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == dev_type.CUDA:
            ops.append((e.name, tr.start, tr.end))
        elif e.cpu_parent is None:
            host.append((tr.start, tr.end, e.name))
    if not ops:
        return None
    ops.sort(key=lambda o: o[1])
    merged = []
    for _, t0, t1 in ops:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) / 1e6
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: python between operations"
        if i >= 0 and host[i][1] >= mid:
            name = f"host: {host[i][2]}"
        gaps.append((name, (b - a) / 1e6))
    return Slice(window_s=window_s, ops=ops, busy_s=busy, gaps=gaps)
