"""The share of the batched paged decode ticks that replayed the step's
CUDA graph: 100 x the mean of the ``decode_tick`` spans' ``graph`` (1 a
replay, 0 an eager step), one a tick, outside the profiled slice, in %;
a program counter.  Silent where the program records no ``graph``."""

from portbench.callattrs import mean_attr


def read(w):
    m = mean_attr(w, "decode_tick", "graph")
    return None if m is None else 100.0 * m
