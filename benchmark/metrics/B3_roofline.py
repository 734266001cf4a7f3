"""The training forward kernel's (B3, forward with logsumexp) share of its
roofline over the traced steps (47 launches a step with remat)."""
import readers


def read(run):
    return readers.roofline(run, "B3")
