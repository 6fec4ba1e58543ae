"""The collector's pauses: the summed time of the program's ``gc`` spans
(one a garbage collection) in the window outside the profiled slice,
over the window less the slice, in ms a second; program spans.  (On the
CPU, where the profile holds no device slice, over the whole window.)"""


def read(w):
    lo, hi = w.win
    a, b = w.slice if w.slice else (hi, hi)
    paused = [s.t1 - s.t0 for s in w.spans
              if s.phase == "gc" and s.t1 is not None
              and lo <= s.sid < hi and not a <= s.sid < b]
    outside = w.window_s - (w.trace.window_s if w.trace is not None
                            else 0.0)
    if not paused or outside <= 0:
        return None
    return 1e3 * sum(paused) / outside
