"""Arithmetic the per-layer metric readers (benchmark/metrics/) share.
Each returns None where the run holds nothing to read (a CPU run has no
device trace; a cell without the span or the kernel): the harness then
leaves the metric out of the line."""
from __future__ import annotations

import re
from typing import Optional

import counters


def host_ms_per_call(run, span: str) -> Optional[dict]:
    times = run.spans.get(span)
    if not times:
        return None
    return {"value": 1e3 * sum(times) / len(times)}


def range_device_ms_per_audio_s(run, name: str) -> Optional[dict]:
    if run.trace is None or not run.window.get("traced_audio_s"):
        return None
    r = run.trace["ranges"].get(name)
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return {"value": 1e3 * r["device_s"] / run.window["traced_audio_s"],
            "note": f"{r['count']} ranges, device time by {r['via']}"}


def idle_share(run) -> Optional[dict]:
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return {"value": 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])}


def mfu(run) -> Optional[dict]:
    w = run.window
    if not w.get("model_flops") or not w.get("wall_s") or run.trace is None \
            or run.trace["busy_s"] <= 0:  # a run without a device
        return None
    return {"value": 100.0 * w["model_flops"] / (w["wall_s"] * run.peaks["bf16_flops"])}


def roofline(run, kernel: str) -> Optional[dict]:
    """A hand kernel's share of its roofline over the traced window: the
    least time its launches could take (operations at the peak of its
    operand type, or bytes at the HBM rate, whichever is larger) over its
    device time.  The profiler can miss a launch: the device time is scaled
    by the launches the program counted over the events recorded."""
    work = run.kernel_work.get(kernel)
    if run.trace is None or not work or not work["launches"]:
        return None
    times = [t for name, ts in run.trace["kernels"].items() if re.search(work["kernel"], name)
             for t in ts]
    if not times:
        return None
    # a launch may run several kernels (B5: dk/dv and dbias), each an event
    recorded = len(times) / work.get("kernels_per_launch", 1)
    device_s = sum(times) * work["launches"] / recorded
    if work["launches"] != work["calls"]:
        return None  # the launches counted are not the calls whose work was counted
    least, bound = counters.bound_seconds(work["ops"], work["bytes"], run.peaks[work["peak"]],
                                          run.peaks["hbm_bytes_per_s"])
    return {"value": 100.0 * least / device_s,
            "note": f"{bound}: {work['ops']:.6g} ops, {work['bytes']:.6g} bytes, "
                     f"{work['launches']} launches, {len(times)} recorded"}
