"""The mean wait of a stage in a module queue (the scheduler's
``admission`` spans begun in the window, outside the profiled slice), in
ms; program spans."""

from portbench.readers import mean


def read(w):
    lo, hi = w.win
    a, b = w.slice if w.slice else (hi, hi)
    m = mean(s.t1 - s.t0 for s in w.spans
             if s.phase == "admission" and s.t1 is not None
             and lo <= s.sid < hi and not a <= s.sid < b)
    return None if m is None else 1e3 * m
