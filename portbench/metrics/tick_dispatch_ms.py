"""The mean dispatch of a batched paged decode tick: the ``decode_tick``
spans' ``dispatch_s`` (the ``s2m3.decode.dispatch`` scope: the tokens',
tables' and lengths' copies and the step's launches), one a tick,
outside the profiled slice, in ms; program spans."""

from portbench.callattrs import mean_attr_ms


def read(w):
    return mean_attr_ms(w, "decode_tick", "dispatch_s")
