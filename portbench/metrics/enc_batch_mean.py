"""The mean batch of the window's encoder calls (one span per call's
request, grouped by call), outside the profiled slice; program spans."""

from portbench.readers import mean_batch


def read(w):
    return mean_batch(w, "encode")
