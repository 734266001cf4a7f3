"""The gated-attention forward kernel's (B1) share of its roofline in the
traced window: its operations (valid queries x valid keys) or bytes at
the peak, whichever bounds it, over its device time."""
import readers


def read(run):
    return readers.roofline(run, "B1")
