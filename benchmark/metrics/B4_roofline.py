"""The dQ backward kernel's (B4) share of its roofline over the traced steps."""
import readers


def read(run):
    return readers.roofline(run, "B4")
