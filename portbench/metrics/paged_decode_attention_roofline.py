"""paged_decode_attention's share of its roofline in the profiled
slice: the least time of the decode ticks' paged attention (every
layer's, each live row's keys, ``work.paged_work``) at the published
float32 peak and HBM bandwidth over the device time of the operations
named like ``PATTERN``, in %."""

from portbench.readers import roofline

PATTERN = "paged_decode_fwd"


def read(w):
    return roofline(w, "paged_decode_attention", PATTERN)
