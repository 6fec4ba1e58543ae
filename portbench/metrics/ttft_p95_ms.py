"""ttft_p95_ms: the 95th percentile, by nearest rank, over every request
due in the window (open loop) of the time from when it was due to its
first output: its whole answer (the harness's clock as the answer
reaches it), or for a generative request its first token (the end of
its prefill span, moved onto the harness's clock).  A request that never
finished counts as infinitely late."""

import math

from portbench.readers import nearest_rank


def read(w):
    if not w.due:
        return None
    prefill_end = {}
    for s in w.spans:
        if s.phase == "prefill" and s.t1 is not None:
            prefill_end[s.rid] = s.t1 + w.clock_offset
    lat = []
    for rid in w.due:
        rec = w.recs[rid]
        t = prefill_end.get(rid, rec.t_finish) if rec.spec.output else \
            rec.t_finish
        lat.append(math.inf if math.isnan(t) else t - rec.due)
    return 1e3 * nearest_rank(lat, 0.95)
