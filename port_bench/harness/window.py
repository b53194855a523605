"""What every loop (``loops/<loop>.py``) is: a module whose
``setup(ctx)`` builds the program's call on the cell's inputs
(``harness/cell.py:Context``), warms it up, and returns a :class:`Loop`.
The window's loops are here, so that each mix is measured the same way.

Every rate is exact: all the work of the window over all its time, from a
synchronised start to the synchronise after the last whole step. The clock
is a function argument so that the tests can drive the loops on a fake one.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Tuple


def closed_loop(step: Callable[[], object], seconds: float, sync: Callable[[], None],
                clock: Callable[[], float] = time.perf_counter) -> Dict:
    """``step`` again and again until ``seconds`` have passed since a
    synchronised start, then a synchronise: ``steps`` whole steps over
    ``seconds``, the time from the start to that synchronise."""
    sync()
    n = 0
    t0 = clock()
    while clock() - t0 < seconds:
        step()
        n += 1
    sync()
    return {"steps": n, "seconds": clock() - t0, "latencies": []}


def timed_calls(call: Callable[[], object], seconds: float, sync: Callable[[], None],
                fetch: Callable[[object], float], clock: Callable[[], float] = time.perf_counter) -> Dict:
    """One caller in a closed loop (``cli/common.py:latency_bench``'s
    discipline): each call timed from a synchronised device until its
    outputs are synchronised and fetched to the host; ``seconds`` is the
    time from the first call's start to the last one's end."""
    lat = []
    sync()
    t0 = clock()
    while clock() - t0 < seconds:
        ts = clock()
        out = call()
        sync()
        fetch(out)
        lat.append(clock() - ts)
    return {"steps": len(lat), "seconds": clock() - t0, "latencies": lat}


def warm_up(step: Callable[[], object], sync: Callable[[], None], steps: int) -> None:
    """Warm-up: ``steps`` steps, then a synchronise. A fixed count, so that
    set-up does the same work in every run."""
    for _ in range(steps):
        step()
    sync()


def p95(latencies) -> Optional[float]:
    """The 95th percentile of every latency (``statistics.quantiles``)."""
    return statistics.quantiles(latencies, n=100)[94] if len(latencies) > 1 else None


class Loop:
    """One mix's program call. ``step`` is one timed unit of work (a
    training step, a served call); ``counts`` its FLOPs and assignment calls
    (the configuration module's ``counts``)."""

    counts: Dict = {}

    def __init__(self, ctx):
        self.ctx = ctx

    def step(self) -> None:
        raise NotImplementedError

    def unit(self) -> None:
        """One unit of the window's work as the window times it (the traced
        window's)."""
        self.step()

    def window(self, seconds: float) -> Dict:
        """The measured window: ``steps``, ``seconds``, ``latencies``."""
        return closed_loop(self.step, seconds, self.ctx.sync)

    def traced(self, on: bool) -> None:
        """Open the benchmark's own spans, where the loop has any, around
        parts of each step (the traced window only); a per-layer reader
        names the span it reads."""

    def after_window(self) -> None:
        """Work due once the window has closed and the memory peak is read:
        answers not yet served, the recorded step after the window."""

    def release(self) -> None:
        """Free the program's state before the reference runs."""

    def check(self, control: bool) -> Tuple[Dict, Optional[Dict]]:
        """(the program's numbers, the control's or None)."""
        raise NotImplementedError
