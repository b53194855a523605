"""The annotations of a traced window, each with what happened while it was
open: the program's spans (``utils/profiling.py:span`` in the port:
``train.*``, ``synth.*``, ``vq.*``, ``serve.call``), the benchmark's
``bench.*`` and torch's ``Optimizer.*``.

:func:`summarise` reads the profiler's events of a window that
``harness/trace.py:traced_window`` took. Everything in it is attributed by
time on the profiler's one clock, on any thread, so the work of autograd's
thread inside ``train.step`` counts for ``train.step``. For each
annotation's name:

* ``count``: the annotations of that name that start or are open in the
  window;
* ``host_s``: the time they were open; ``self_host_s`` less the time their
  child annotations on the same thread cover;
* ``device_s``: the device time of the kernels launched under them
  (``harness/trace.py:device_s_under``'s semantics);
* ``idle_s``: the window's device-idle time while one of them was open;
  ``self_idle_s``: the idle time they are the innermost annotation over.
  Each idle interval is cut at every annotation's boundaries, and each piece
  goes to the shortest annotation open over it, on any thread; a piece with
  nothing open but ``bench.window`` goes to ``bench.window``. So the
  ``self_idle_s`` of all names sum to the window's idle time;
* ``launches``: the runtime's kernel launches (:data:`LAUNCH`) that start
  while one of them is open, children included; ``syncs`` likewise, the
  runtime calls that block the host on the card (:func:`is_sync`).

:func:`calls_under` counts launches or syncs from what a traced window's
summary already holds (``host_ops``, each host operation with the names of
the operations around it on its thread), for the per-layer readers.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

from .trace import WINDOW, _device_total_us, _is_device, _union

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH)


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host until the card has caught up: a
    synchronise, or a copy that is not asynchronous."""
    return name.startswith(WAITS) or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def _host(e) -> bool:
    return getattr(e, "device_type", None) != DeviceType.CUDA


def _annotation(e) -> bool:
    return _host(e) and getattr(e, "is_user_annotation", False) and not e.name.startswith("ProfilerStep")


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _contains(intervals: List[Tuple[float, float]], starts: List[float], t: float) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= intervals[k][1]


def summarise(events) -> Dict[str, Dict[str, float]]:
    """``{name: {count, host_s, self_host_s, device_s, idle_s, self_idle_s,
    launches, syncs}}`` of every annotation open in the ``bench.window``
    annotation of ``events``; empty without one."""
    windows = [e for e in events if e.name == WINDOW and _host(e)]
    if not windows:
        return {}
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if _is_device(e) and e.time_range.end > w0 and e.time_range.start < w1])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    spans = [e for e in events if _annotation(e) and e.time_range.start < w1 and e.time_range.end > w0]
    clip = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in spans]

    # the annotations' nesting on each thread: self time, and device time counted once per name
    parent: Dict[int, Optional[int]] = {}
    covered: Dict[int, float] = defaultdict(float)
    by_thread: Dict[object, List[int]] = defaultdict(list)
    for i, e in enumerate(spans):
        by_thread[getattr(e, "thread", 0)].append(i)
    for members in by_thread.values():
        stack: List[int] = []
        for i in sorted(members, key=lambda i: (spans[i].time_range.start, -spans[i].time_range.end)):
            while stack and (spans[i].time_range.start >= spans[stack[-1]].time_range.end
                             or spans[i].time_range.end > spans[stack[-1]].time_range.end):
                stack.pop()
            parent[i] = stack[-1] if stack else None
            if stack:
                covered[stack[-1]] += clip[i][1] - clip[i][0]
            stack.append(i)

    def outermost(i: int) -> bool:
        p = parent[i]
        while p is not None:
            if spans[p].name == spans[i].name:
                return False
            p = parent[p]
        return True

    # each idle piece to the shortest annotation open over it
    self_idle: Dict[str, float] = defaultdict(float)
    cuts = sorted({x for ab in clip for x in ab})
    bounds = sorted([(a, 0, i) for i, (a, _) in enumerate(clip)] + [(b, 1, i) for i, (_, b) in enumerate(clip)])
    length = [e.time_range.end - e.time_range.start for e in spans]
    active: Dict[int, Tuple[float, float]] = {}
    j = 0
    for a, b in idle:
        points = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for p, q in zip(points, points[1:]):
            mid = 0.5 * (p + q)
            while j < len(bounds) and bounds[j][0] <= mid:
                t, kind, i = bounds[j]
                if kind == 0:
                    active[i] = (length[i], -spans[i].time_range.start)
                else:
                    active.pop(i, None)
                j += 1
            if active:
                self_idle[spans[min(active, key=active.get)].name] += q - p

    calls = sorted((e.time_range.start, e.name) for e in events
                   if _host(e) and w0 <= e.time_range.start <= w1 and (is_launch(e.name) or is_sync(e.name)))
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted({e.name for e in spans}):
        members = [i for i, e in enumerate(spans) if e.name == name]
        union = _union([clip[i] for i in members])
        starts = [a for a, _ in union]
        inside = [n for t, n in calls if _contains(union, starts, t)]
        top = [i for i in members if outermost(i)]
        out[name] = {
            "count": len(members),
            "host_s": sum(clip[i][1] - clip[i][0] for i in top) / 1e6,
            "self_host_s": sum(clip[i][1] - clip[i][0] - covered[i] for i in members) / 1e6,
            "device_s": sum(_device_total_us(spans[i]) for i in top) / 1e6,
            "idle_s": _overlap(union, idle) / 1e6,
            "self_idle_s": self_idle.get(name, 0.0) / 1e6,
            "launches": sum(1 for n in inside if is_launch(n)),
            "syncs": sum(1 for n in inside if is_sync(n)),
        }
    return out


def calls_under(trace: Optional[Dict], names: Iterable[str], match: Callable[[str], bool]) -> Optional[int]:
    """The runtime calls that ``match`` (:func:`is_launch`, :func:`is_sync`)
    among the traced window's host operations with an operation named in
    ``names`` around them on their thread (the summary's ``host_ops``);
    None where the window ran nothing on the card or no such operation
    started in it."""
    names = set(names)
    ops = trace.get("host_ops", ()) if trace else ()
    if not trace or not trace.get("busy_s") or not any(name in names for name, _, _ in ops):
        return None
    return sum(1 for name, _, around in ops if match(name) and names.intersection(around))


def per_unit(run, names: Iterable[str], match: Callable[[str], bool]) -> Optional[float]:
    """:func:`calls_under` over the traced window's units of work (steps or
    calls)."""
    t = run.get("trace")
    n = calls_under(t, names, match)
    return None if n is None or not t.get("steps") else n / t["steps"]
