"""The device's idle share of the profiled slice: 1 - the union of its
operations' intervals over the slice's wall time, in %; device trace."""

from portbench.readers import idle_share


def read(w):
    return idle_share(w)
