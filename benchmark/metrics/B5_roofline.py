"""The dK/dV backward (B5: its dk/dv and dbias kernels summed) share of its
roofline over the traced steps."""
import readers


def read(run):
    return readers.roofline(run, "B5")
