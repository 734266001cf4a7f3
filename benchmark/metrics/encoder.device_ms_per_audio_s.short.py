"""Device milliseconds of the kernels launched inside the pipeline's
`encode_waveform` (the benchmark's `bench.encode` range) per second of
audio, over the traced window."""
import readers


def read(run):
    return readers.range_device_ms_per_audio_s(run, "bench.encode")
