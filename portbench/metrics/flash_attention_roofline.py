"""flash_attention's share of its roofline in the profiled slice: the
least time of the attention work the slice's calls imply (every
encoder batch's or prefill's layers, ``work.flash_work`` at the
published float32 peak and HBM bandwidth) over the device time of the
operations named like ``PATTERN``, in %."""

from portbench.readers import roofline

PATTERN = "flash_fwd"


def read(w):
    return roofline(w, "flash_attention", PATTERN)
