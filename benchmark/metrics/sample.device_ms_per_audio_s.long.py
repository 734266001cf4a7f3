"""Device milliseconds of the kernels launched inside the pipeline's
`sample_nbest` (the decoder's calls and the sampler's posterior; the
benchmark's `bench.sample` range) per second of audio, over the traced
window."""
import readers


def read(run):
    return readers.range_device_ms_per_audio_s(run, "bench.sample")
