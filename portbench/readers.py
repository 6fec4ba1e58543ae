"""Arithmetic the metric readers (``metrics/<name>.py``) share.  Each
reader is a file with ``read(window)`` returning a number, or None when
the window holds nothing for it to read (the harness then leaves the
metric out of the result)."""

from __future__ import annotations

import math

from portbench import work


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def nearest_rank(values, q: float):
    """The q-quantile by nearest rank (every sample counts; inf stays)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def calls(w, phase: str):
    """The window's calls of ``phase`` outside the profiled slice."""
    return [c for c in w.span_metric_calls() if c["phase"] == phase]


def mean_ms(w, phase: str):
    m = mean(c["t1"] - c["t0"] for c in calls(w, phase))
    return None if m is None else 1e3 * m


def mean_batch(w, phase: str):
    return mean(len(c["rids"]) for c in calls(w, phase))


def mfu(w):
    """Model FLOPs of the window's device calls over the window at the
    float32 peak, in %."""
    flops = sum(f for c in w.calls for kind, f, _ in w.bench.call_work(c)
                if kind == "model")
    if not flops or w.window_s <= 0:
        return None
    return 100.0 * flops / (w.window_s * work.PEAK_FLOPS_F32)


def roofline(w, kernel: str, pattern: str, dtype: str = "float32"):
    """The least time the slice's calls of ``kernel`` could take (the
    traffic's work at the published peaks) over the device time of the
    operations named like ``pattern``, in %."""
    if w.trace is None:
        return None
    least = 0.0
    for c in w.slice_calls:
        for kind, f, b in w.bench.call_work(c):
            if kind == kernel:
                least += work.bound_s(b, f, dtype)
    spent = w.trace.device_seconds(lambda name: pattern in name)
    if not least or not spent:
        return None
    return 100.0 * least / spent


def idle_share(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
