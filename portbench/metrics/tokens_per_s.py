"""tokens_per_s: every token generated in the window (each prefill's
first token and each decode row's), over the window on the host's
clock.  The counts are the scheduler's stable stats (``decode_tokens``
and ``prefills``) read at the open and at the close."""


def read(w):
    n = w.stat_delta("decode_tokens") + w.stat_delta("prefills")
    return n / w.window_s if n and w.window_s > 0 else None
