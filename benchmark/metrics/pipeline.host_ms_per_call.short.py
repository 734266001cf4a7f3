"""Host milliseconds of each `transcribe_with_ids_async` enqueue in the
measured window (the benchmark's own span).  Near the device time of a
batch, the host is paced by the device (a full launch queue, or a hidden
synchronization) rather than ahead of it."""
import readers


def read(run):
    return readers.host_ms_per_call(run, "dispatch")
