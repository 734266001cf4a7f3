"""Share of the traced steps' window in which no operation ran on the device."""
import readers


def read(run):
    return readers.idle_share(run)
