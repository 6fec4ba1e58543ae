"""setup_s: seconds from the process's start to the window's open
(imports, weights, inputs, warm-up, the closed loop's fill); host clock."""


def read(w):
    return w.setup_s
