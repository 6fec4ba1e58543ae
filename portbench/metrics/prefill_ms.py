"""The mean time of a batch-1 prefill (``prefill`` spans, first token
read included), outside the profiled slice, in ms."""

from portbench.readers import mean_ms


def read(w):
    return mean_ms(w, "prefill")
