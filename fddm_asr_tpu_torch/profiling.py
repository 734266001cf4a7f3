# -*- coding: utf-8 -*-
"""Tracing and step timing for the training loop.

Counterpart of `fddm_asr_tpu/profiling.py`:

  * `trace(logdir)`: the whole block under `torch.profiler` (host and, on
    a GPU, device events), written as a Chrome trace `trace_<pid>.json`
    into `logdir` when the block ends, also when it raises;
  * `annotate(name)`: a `record_function` range, under the span names the
    JAX loop uses (`host_to_device`);
  * `nan_guard(enabled)`: autograd anomaly mode (a backward op that makes
    a NaN raises there) and a `check` of each step's loss that raises at
    the step when it is not finite; the previous anomaly mode is restored
    on exit.  The counterpart of `jax_debug_nans`;
  * `StepTimer`: rolling step times with the first steps (warm-up) and
    outliers left out.  On a GPU each tick records a CUDA event, so the
    times follow the device, not the host's dispatch; `host_lead_s` says
    how far the host ran ahead of the device at the last tick;
  * `breakdown(prof, ...)`: a finished torch.profiler window's device time
    by kernel name, busy time as the union of the device events'
    intervals, their overlap, nested events and named ranges;
    `top_by_track` / `print_listing`: the summed time of each event name on
    each track (a device stream, or the host thread when the window holds
    no device event), the counterpart of `scripts/profile_step.py`'s
    `aggregate` over a jax.profiler trace;
  * `gated_attention_flops`: the products a gated-attention kernel does on
    given shapes, for FLOP counts that a dispatch mode cannot see (the
    hand-written kernels are launched outside torch's dispatcher).
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

__all__ = ["trace", "annotate", "nan_guard", "NanGuard", "StepTimer", "breakdown",
           "top_by_track", "print_listing", "gated_attention_flops", "profile_iters",
           "PORT_KERNEL_EVENT"]


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block when `logdir` is set; no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class NanGuard:
    """`check(loss, step)` raises FloatingPointError for a non-finite loss
    when enabled (it then waits for the device); a no-op otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def check(self, loss: torch.Tensor, step: int) -> None:
        if self.enabled and not bool(torch.isfinite(loss).all()):
            raise FloatingPointError(f"non-finite loss {float(loss)} at step {step}")


@contextlib.contextmanager
def nan_guard(enabled: bool = True) -> Iterator[NanGuard]:
    guard = NanGuard(enabled)
    if not enabled:
        yield guard
        return
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield guard
    finally:
        torch.autograd.set_detect_anomaly(*prev)


class StepTimer:
    """Rolling step timing; the first `skip` intervals (warm-up) are left out.

    `pause()` forgets the last tick across a gap that is no step (eval,
    checkpoints, the epoch's turn).  An interval over 10x the window's
    median with at least 5 banked is dropped as a stall.  With a CUDA
    `device` the intervals are read from CUDA events when a rate is asked
    for, which waits for the device to reach the last tick."""

    def __init__(self, skip: int = 1, window: int = 50, device=None):
        self.skip = skip
        self.window = window
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._times: List[float] = []
        self._pending: List[Tuple] = []
        self._count = 0
        self._last = None

    def _mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def tick(self) -> None:
        mark = self._mark()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip:
                self._pending.append((self._last, mark))
        self._last = mark

    def pause(self) -> None:
        self._last = None

    def _drain(self) -> None:
        for a, b in self._pending:
            if self.cuda:
                b.synchronize()
                dt = a.elapsed_time(b) / 1e3
            else:
                dt = b - a
            if len(self._times) >= 5 and dt > 10.0 * sorted(self._times)[len(self._times) // 2]:
                continue
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._pending.clear()

    @property
    def seconds_per_step(self) -> Optional[float]:
        self._drain()
        if not self._times:
            return None
        return sum(self._times) / len(self._times)

    def throughput(self, batch_size: int) -> Optional[float]:
        sps = self.seconds_per_step
        return batch_size / sps if sps else None

    def host_lead_s(self) -> Optional[float]:
        """Host seconds until the device reaches the last tick: how far the
        host's dispatch ran ahead of the device (None off the GPU)."""
        if not self.cuda or self._last is None:
            return None
        t0 = time.perf_counter()
        self._last.synchronize()
        return time.perf_counter() - t0


def _device_time_us(e) -> float:
    total = getattr(e, "device_time_total", None)
    return e.cuda_time_total if total is None else total


def breakdown(prof, wall_ms: float, profiled_ms: float, ranges: Sequence[str] = ()) -> dict:
    """The device time of a finished `torch.profiler.profile` window:
    `wall_ms` the wall time of an unprofiled run of the same work,
    `profiled_ms` the window's own.  Device time by event name; busy time
    as the union of the device events' intervals, so time that two events
    share (a duplicate, an annotation spanning kernels, a second stream)
    counts once; `overlap_ms` the plain sum of event times less the union;
    `nested_ms` the events that lie wholly inside an earlier one, by name,
    and `containers` the names that hold them; idle shares against both
    walls, unclamped.  For each name in `ranges` (a `record_function` range)
    its count, the device time of the kernels launched inside it
    (`device_ms`), its device-side spans (`span_ms`, gaps included; they
    stay out of the busy time) and its host time (`host_ms`).  Raises
    RuntimeError when the window holds no device event."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in ranges)
    in_ranges = {name: {"count": 0, "device_ms": 0.0, "span_ms": 0.0, "host_ms": 0.0}
                 for name in ranges}
    for e in prof.events():
        if e.name not in in_ranges:
            continue
        r = in_ranges[e.name]
        if e.device_type == DeviceType.CUDA:
            r["span_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        else:
            r["count"] += 1
            r["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
            r["device_ms"] += _device_time_us(e) / 1e3
    if not spans:
        raise RuntimeError("the profiler saw no device event")
    per_kernel, nested, containers = {}, {}, {}
    busy_us = sum_us = 0.0
    holder = None  # the event reaching furthest so far: (end, name)
    cover_start = cover_end = None
    for start, neg_end, name in spans:
        end = -neg_end
        sum_us += end - start
        per_kernel[name] = per_kernel.get(name, 0.0) + (end - start) / 1e3
        if holder is not None and end <= holder[0]:  # inside an earlier event
            nested[name] = nested.get(name, 0.0) + (end - start) / 1e3
            containers[holder[1]] = containers.get(holder[1], 0) + 1
        else:
            holder = (end, name)
        if cover_end is None or start > cover_end:
            if cover_end is not None:
                busy_us += cover_end - cover_start
            cover_start, cover_end = start, end
        else:
            cover_end = max(cover_end, end)
    busy_us += cover_end - cover_start
    busy_ms = busy_us / 1e3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {"device_busy_ms": busy_ms, "event_sum_ms": sum_us / 1e3,
            "overlap_ms": (sum_us - busy_us) / 1e3,
            "nested_ms": dict(sorted(nested.items(), key=lambda kv: -kv[1])[:8]),
            "containers": dict(sorted(containers.items(), key=lambda kv: -kv[1])[:8]),
            "wall_ms": wall_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "profiled_wall_ms": profiled_ms, "idle_share_profiled": 1.0 - busy_ms / profiled_ms,
            "kernels": len(per_kernel),
            "top": [{"name": n[:90], "ms": ms, "share": ms / busy_ms} for n, ms in ranked[:12]],
            "all": [{"name": n, "ms": ms} for n, ms in ranked], "ranges": in_ranges}


def top_by_track(prof, top: int) -> Dict[str, Tuple[float, List[Tuple[str, float]]]]:
    """{track: (its total ms, its `top` event names by summed ms)}.  A
    track is a device stream ("cuda:0 stream 7") when the window holds
    device events, else a host thread ("cpu thread 1").  Events nest (a
    range over kernels, an op over its callees): each name's time is summed
    as recorded, as the JAX script sums each track's events, so read the
    names of one level against each other."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    per_track: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
    for e in on_device or events:
        if on_device:
            track = f"cuda:{e.device_index} stream {e.thread}"
        else:
            track = f"cpu thread {e.thread}"
        per_track[track][e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return {track: (sum(per_op.values()), per_op.most_common(top))
            for track, per_op in sorted(per_track.items())}


def print_listing(prof, top: int, file=None) -> Dict[str, Tuple[float, List[Tuple[str, float]]]]:
    """Print `top_by_track` as the JAX script's `aggregate` does; returns it."""
    listing = top_by_track(prof, top)
    for track, (total, ops) in listing.items():
        print(f"\n== track '{track}': {total:.1f} ms total ==", file=file)
        for name, ms in ops:
            print(f"  {ms:9.2f} ms  {name[:110]}", file=file)
    return listing


# products per (query, kept key) pair, head and head dim: B1/B3 q.k and p.v;
# B4 q.k, dO.v and dS.k; B5 q.k, dO.v, P^T.dO and dS^T.q (2 FLOPs a product)
ATTENTION_PRODUCT_FLOPS = {"fwd": 4, "fwd_lse": 4, "bwd_dq": 6, "bwd_dkv": 8}


def gated_attention_flops(kind: str, kept: Sequence[int], L: int, H: int,
                          head_dim: int = 64) -> float:
    """The FLOPs of one gated-attention kernel call (`kind`: fwd, fwd_lse,
    bwd_dq or bwd_dkv) on B = len(kept) rows of L queries, row b keeping
    kept[b] keys: the products over (query, kept key) pairs.  A row with no
    kept key costs the forward the mean of v (L * H * head_dim) and B5 the
    column sum of dO (the same), nothing in B3 or B4."""
    pairs = sum(L * n for n in kept)
    flops = ATTENTION_PRODUCT_FLOPS[kind] * head_dim * H * pairs
    if kind in ("fwd", "bwd_dkv"):
        flops += sum(1 for n in kept if n == 0) * L * H * head_dim
    return float(flops)


# a device event of one of the port's hand-written kernels (csrc/)
PORT_KERNEL_EVENT = re.compile(
    r"(gated_attention|bwd_dq|bwd_dkv|bwd_dbias|int8_matmul_fused|conv_ln_gelu)\w*_kernel")


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_iters(run, iters: int, out: str, top: int) -> dict:
    """`iters` calls of `run()` under torch.profiler (host and, on a GPU,
    device activity), then the Chrome trace written as
    `out/trace_<pid>.json` and `print_listing`'s table printed.  Returns
    per call: the profiled wall ms, each kernel wrapper's launches (counted
    by the wrappers, reset before the window), the device events of the
    port's kernels by name (counted by the profiler, which can miss some);
    and with device events `breakdown`'s busy ms and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from fddm_asr_tpu_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
            _synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    os.makedirs(out, exist_ok=True)
    trace_path = os.path.join(out, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(trace_path)
    print_listing(prof, top)
    from torch.autograd import DeviceType

    kernels = collections.Counter()
    for e in prof.events():
        m = PORT_KERNEL_EVENT.search(e.name)
        if e.device_type == DeviceType.CUDA and m:
            kernels[m.group(0)] += 1
    result = {"iters": iters, "wall_ms": wall_ms, "trace": trace_path,
              "launches": {k: f.launches / iters for k, f in wrappers.items() if f.launches},
              "kernel_events": {k: n / iters for k, n in sorted(kernels.items())}}
    try:
        b = breakdown(prof, wall_ms * iters, wall_ms * iters)
    except RuntimeError:  # no device event: a CPU run
        return result
    result.update(device_busy_ms=b["device_busy_ms"] / iters, idle_share=b["idle_share"],
                  overlap_ms=b["overlap_ms"] / iters,
                  top=[{"name": t["name"], "ms": t["ms"] / iters} for t in b["top"][:10]])
    return result
