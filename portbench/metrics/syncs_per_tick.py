"""Blocking device-to-host reads a batched paged decode tick makes (the
``decode_tick`` spans' ``syncs``: a token read a live row), the mean
over every tick of the window, the profiled slice included, as
``rows_per_tick`` counts its rows; a program counter."""

from portbench.readers import mean


def read(w):
    return mean(c["attrs"]["syncs"] for c in w.calls
                if c["phase"] == "decode_tick" and "syncs" in c["attrs"])
