"""Model FLOPs of the measured window's audio (valid frames; the encoder
and the sampler's decoder calls) over the window's wall time at the
card's bf16 dense peak."""
import readers


def read(run):
    return readers.mfu(run)
