"""Share of the traced window in which no operation ran on the device
(1 - the union of the device events' intervals over the window)."""
import readers


def read(run):
    return readers.idle_share(run)
