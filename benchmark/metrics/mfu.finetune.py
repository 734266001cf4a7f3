"""Model FLOPs of the measured window's steps (frozen front-end forward,
the rest 3x; valid tokens) over its wall time at the card's bf16 dense peak."""
import readers


def read(run):
    return readers.mfu(run)
