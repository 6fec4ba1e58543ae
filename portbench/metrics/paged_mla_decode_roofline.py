"""paged_mla_decode's share of its roofline in the profiled slice: the
least time of the decode ticks' absorbed latent attention (every
layer's, each live row's keys, ``mla_work.paged_mla_work``, from the
configuration's ``call_work``) at the published float32 peak and HBM
bandwidth over the device time of the operations named like
``PATTERN`` (the kernel and its split merge), in %.  Silent where the
slice holds no such operation."""

from portbench.readers import roofline

PATTERN = "paged_mla"


def read(w):
    return roofline(w, "paged_mla_decode", PATTERN)
