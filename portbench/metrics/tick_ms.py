"""The mean time of a batched paged decode tick (``decode_tick`` spans,
one a row, grouped by tick), outside the profiled slice, in ms."""

from portbench.readers import mean_ms


def read(w):
    return mean_ms(w, "decode_tick")
