"""Decode rows a tick: the scheduler's ``decode_tokens`` over its
``decode_steps`` in the window; program counters."""


def read(w):
    steps = w.stat_delta("decode_steps")
    return w.stat_delta("decode_tokens") / steps if steps else None
