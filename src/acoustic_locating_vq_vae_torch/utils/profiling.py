"""Profiling and timing.

Counterpart of ``acoustic_locating_vq_vae_tpu/utils/profiling.py``:
``torch.profiler`` traces in place of ``jax.profiler``, and timers that wait
for the card (``torch.cuda.synchronize``) in place of ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "StepTimer", "time_fn"]


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block (host, and the card when there is one) and write a
    Chrome trace, ``<log_dir>/<name>.json``, that Perfetto reads."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def _wait(result: Any) -> None:
    """Wait until the card has computed every CUDA tensor in ``result``."""
    for device in {t.device for t in tree_leaves(result) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class StepTimer:
    """Host-clock step timer that waits for the card's result, with running
    statistics (mean / p50 / p90)."""

    def __init__(self):
        self.samples = []

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        _wait(out.get("result", result))
        self.samples.append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "steps": len(a),
        }


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1, **kwargs) -> Dict[str, float]:
    """Steady-state timing of a callable (warm-up calls excluded)."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _wait(out)
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_call": dt, "calls_per_sec": 1.0 / dt}
