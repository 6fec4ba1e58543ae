"""The mean rest of a batched paged decode tick after its dispatch: a
``decode_tick`` span's ``t1 - t0 - dispatch_s`` (the
``s2m3.decode.read`` scope: the wait for the step and the rows' token
reads), one a tick, outside the profiled slice, in ms; program spans.
With ``tick_dispatch_ms`` it sums to ``tick_ms``."""

from portbench.readers import calls, mean


def read(w):
    m = mean(c["t1"] - c["t0"] - c["attrs"]["dispatch_s"]
             for c in calls(w, "decode_tick") if "dispatch_s" in c["attrs"])
    return None if m is None else 1e3 * m
