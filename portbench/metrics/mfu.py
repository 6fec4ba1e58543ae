"""The whole step's share of the card's float32 peak: the model FLOPs
of every device call in the window (counted by the configuration's
``call_work`` from shapes, ``portbench/work.py``'s arithmetic) over the
window times 67 TFLOP/s, in %."""

from portbench.readers import mfu


def read(w):
    return mfu(w)
