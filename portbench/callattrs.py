"""What the metric readers of the device calls' span attributes share.
A program that records no such attribute leaves the readers silent."""

from __future__ import annotations

from portbench.readers import calls, mean


def mean_attr(w, phase: str, key: str):
    """The mean of attribute ``key`` over the window's calls of
    ``phase`` outside the profiled slice, or None where none has it."""
    return mean(c["attrs"][key] for c in calls(w, phase)
                if key in c["attrs"])


def mean_attr_ms(w, phase: str, key: str):
    m = mean_attr(w, phase, key)
    return None if m is None else 1e3 * m
