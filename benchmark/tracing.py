"""Reduce a finished torch.profiler window to what the per-layer readers
read: device busy time (the union of the device events' intervals, as the
program's `profiling.breakdown` reckons it), device time by kernel name,
the device time of the kernels launched under the benchmark's
`record_function` ranges, and the longest device-idle gaps labelled by what
the host was doing then.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Sequence

RANGE_PREFIX = "bench."


def summarize(prof, window_s: float, ranges: Sequence[str]) -> dict:
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    # a `record_function` range also shows on the device's timeline, spanning
    # its kernels and the gaps between them: not device work
    named = {e.name for e in host}
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CUDA and e.name not in named
                    and not getattr(e, "is_user_annotation", False))
    by_name: Dict[str, List[float]] = collections.defaultdict(list)
    busy_us, gaps = 0.0, []
    cover_start = cover_end = None
    for start, end, name in device:
        by_name[name].append((end - start) / 1e6)
        if cover_end is None or start > cover_end:
            if cover_end is not None:
                busy_us += cover_end - cover_start
                gaps.append((cover_end, start))
            cover_start, cover_end = start, end
        else:
            cover_end = max(cover_end, end)
    if cover_end is not None:
        busy_us += cover_end - cover_start
    in_ranges = {r: {"count": 0, "device_s": 0.0, "host_s": 0.0, "via": "device spans"}
                 for r in ranges}
    cpu_side = dict.fromkeys(ranges, 0.0)
    for e in host:
        if e.name in in_ranges:
            in_ranges[e.name]["count"] += 1
            in_ranges[e.name]["host_s"] += (e.time_range.end - e.time_range.start) / 1e6
            total = getattr(e, "device_time_total", None)
            cpu_side[e.name] += (e.cuda_time_total if total is None else total) / 1e6
    # a range's device time: the kernels that start inside the range's spans
    # on the device's timeline (the profiler's annotation of it there); the
    # host-side event's device total where the trace has no such span
    for name, r in in_ranges.items():
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name == name)
        if not spans:
            r.update(device_s=cpu_side[name], via="host event")
            continue
        starts = [sp[0] for sp in spans]
        for start, end, _ in device:
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start < spans[i][1]:
                r["device_s"] += (end - start) / 1e6
    ops = sorted(((n, sum(d)) for n, d in by_name.items()), key=lambda kv: -kv[1])
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "events": len(device),
            "kernels": {n: d for n, d in by_name.items()}, "ranges": in_ranges,
            "device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": _label_gaps(gaps, host)}


def _label_gaps(gaps, host) -> list:
    """The idle time between device events, summed by what the host was in
    at the gap's start: the outermost benchmark range and the innermost op
    around that moment.  The 10 largest sums."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                   if e.time_range.end > e.time_range.start)
    starts = [s for s, _, _ in spans]
    ours = [sp for sp in spans if sp[2].startswith(RANGE_PREFIX)]
    totals: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        outer = next((name for s, e, name in ours if s <= g0 < e), "")
        inner, inner_len = "outside any host op", None
        for s, e, name in spans[max(0, i - 2000):i]:
            if s <= g0 < e and not name.startswith(RANGE_PREFIX):
                if inner_len is None or e - s < inner_len:
                    inner, inner_len = name, e - s
        totals[f"{outer}/{inner}" if outer else inner] += (g1 - g0) / 1e6
    return [[k[:120], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
