"""The mean dispatch of a batch-1 prefill: the ``prefill`` spans'
``dispatch_s`` (the ``s2m3.prefill.dispatch`` scope: the prompt's copy,
the layers' launches, the page writes), outside the profiled slice, in
ms; program spans."""

from portbench.callattrs import mean_attr_ms


def read(w):
    return mean_attr_ms(w, "prefill", "dispatch_s")
