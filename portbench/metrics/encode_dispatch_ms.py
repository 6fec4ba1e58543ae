"""The mean dispatch of an encoder call: the ``encode`` spans'
``dispatch_s`` (the ``s2m3.encode.dispatch`` scope: the batch's
concatenation and copy to the card, the tower's launches), one a batch,
outside the profiled slice, in ms; program spans."""

from portbench.callattrs import mean_attr_ms


def read(w):
    return mean_attr_ms(w, "encode", "dispatch_s")
