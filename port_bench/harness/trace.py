"""A traced window of a cell and what the per-layer readers take from it.

The window runs under ``torch.profiler`` (host and card) after one traced
but unrecorded step of its own (the first moments of a trace can lose
kernels), inside a ``bench.window`` annotation that ends in a synchronise.
From the events inside that annotation it derives:

* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy, set) ran on the card, and ``window_s``, the annotation's length;
* ``device_ops``: device time by operation name, and ``idle_gaps``: the
  gaps between device intervals by what the host was doing (the innermost
  host operation over each gap's middle, or "python between ops" where the
  host ran Python outside any operation);
* ``kernels``: every device operation's full name and seconds, and
  ``host_ops``: every host operation (an ``aten::`` call, a
  ``record_function`` span of the program or of the benchmark) with the
  device seconds of the kernels it launched, itself or through the
  operations inside it (the profiler's correlation of each kernel with its
  launch), and the names of the operations around it.

What a per-layer metric attributes time by (kernel-name patterns, host
operations) lives in its own reader, ``metrics/<name>.py``, which asks
:func:`kernel_time` and :func:`device_s_under`; nothing here names a layer.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

WINDOW = "bench.window"


def _device_total_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_device(e) -> bool:
    """An operation that ran on the card: a kernel, a copy or a set, not
    the device-side range of a host annotation (``record_function``)."""
    return getattr(e, "device_type", None) == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
        and e.name != WINDOW and not e.name.startswith("ProfilerStep")


def traced_window(loop, steps: int, sync: Callable[[], None]) -> Dict:
    """Run ``steps`` of the loop's units of work in a traced window and
    summarise it."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    plan = schedule(wait=0, warmup=1, active=1, repeat=1)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    loop.traced(True)
    try:
        with profile(activities=activities, schedule=plan) as prof:
            loop.unit()
            sync()
            prof.step()
            t0 = time.perf_counter()
            with record_function(WINDOW):
                for _ in range(steps):
                    loop.unit()
                sync()
            host_s = time.perf_counter() - t0
            prof.step()
    finally:
        loop.traced(False)
    t_read = time.perf_counter()
    out = summarise(prof.events())
    out["host_window_s"] = host_s
    out["steps"] = steps
    out["read_s"] = time.perf_counter() - t_read
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_ops(events, w0: float, w1: float) -> List[Tuple[str, float, Tuple[str, ...]]]:
    """(name, device seconds launched under it, names of the host
    operations around it) of every host operation that starts in the
    window."""
    out = []
    for e in events:
        if getattr(e, "device_type", None) == DeviceType.CUDA or not w0 <= e.time_range.start <= w1:
            continue
        around, parent = [], e.cpu_parent
        while parent is not None:
            around.append(parent.name)
            parent = parent.cpu_parent
        out.append((e.name, _device_total_us(e) / 1e6, tuple(around)))
    return out


def summarise(events) -> Dict:
    windows = [e for e in events if e.name == WINDOW and getattr(e, "device_type", None) != DeviceType.CUDA]
    if not windows:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": [], "kernels": [], "host_ops": []}
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    dev = [e for e in events if _is_device(e) and e.time_range.end > w0 and e.time_range.start < w1]
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev]
    merged = _union(intervals)
    busy_us = sum(b - a for a, b in merged)
    ops: Dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e6
    host = [e for e in events if getattr(e, "device_type", None) != DeviceType.CUDA and e.name != WINDOW
            and not e.name.startswith("ProfilerStep") and e.time_range.end >= w0 and e.time_range.start <= w1]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    spans = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
    # sweep the host operations' boundaries past each gap's middle; the
    # innermost (shortest) open operation names the gap
    bounds = sorted([(e.time_range.start, 0, i) for i, e in enumerate(host)]
                    + [(e.time_range.end, 1, i) for i, e in enumerate(host)])
    active: Dict[int, float] = {}
    j = 0
    for a, b in spans:
        mid = 0.5 * (a + b)
        while j < len(bounds) and bounds[j][0] <= mid:
            t, kind, i = bounds[j]
            if kind == 0:
                active[i] = host[i].time_range.end - host[i].time_range.start
            else:
                active.pop(i, None)
            j += 1
        name = host[min(active, key=active.get)].name if active else "python between ops"
        gaps[name[:120]] += (b - a) / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": top(ops),
        "idle_gaps": top(gaps),
        "kernels": [(e.name, (e.time_range.end - e.time_range.start) / 1e6) for e in dev],
        "host_ops": _host_ops(events, w0, w1),
    }


def kernel_time(trace: Dict, pattern: str) -> Tuple[float, int]:
    """(device seconds, launches) of the traced window's device operations
    whose name holds ``pattern``."""
    hits = [s for name, s in trace.get("kernels", ()) if pattern in name]
    return sum(hits), len(hits)


def device_s_under(trace: Dict, names) -> float:
    """Device seconds of the kernels launched under the host operations
    named in ``names`` (each counted once: an operation inside another of
    ``names`` is left out)."""
    names = set(names)
    return sum(s for name, s, around in trace.get("host_ops", ()) if name in names and not names.intersection(around))
