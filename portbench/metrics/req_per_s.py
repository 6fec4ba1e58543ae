"""req_per_s: requests finished in the window over the window; the
harness's clock stamps each answer as it reaches the client."""


def read(w):
    return w.finished_in / w.window_s if w.window_s > 0 else None
