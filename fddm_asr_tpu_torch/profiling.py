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
    how far the host ran ahead of the device at the last tick.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional, Tuple

import torch

__all__ = ["trace", "annotate", "nan_guard", "NanGuard", "StepTimer"]


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
