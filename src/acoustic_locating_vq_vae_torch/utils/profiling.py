"""Profiling: traces and the program's spans.

Counterpart of ``acoustic_locating_vq_vae_tpu/utils/profiling.py``:
``torch.profiler`` traces in place of ``jax.profiler``.

:func:`span` names a part of the program's work in a trace: a
``torch.profiler.record_function`` annotation while a profiler records, on
the clock of the kernels it launches, so that a trace's idle time, launches
and host waits can be put down to the part that was running. With no
profiler recording it costs one flag read and returns a shared no-op
context, and records nothing. Every profiler records the spans: the one
:func:`trace` runs (``Trainer(profile_dir=)``) and any other.

The program's spans, by layer: the trainer's ``train.sample``,
``train.step``, ``train.backward`` and ``train.otf_batch``; synthesis's
``synth.rir`` and ``synth.spectra``; the quantizer's ``vq.quantize`` and
``vq.perplexity``; the serving closure's ``serve.call``; the codec's
``codec.encode`` and ``codec.decode`` (``models/encodec.py``) and its residual
quantizer's ``rvq.encode`` and ``rvq.decode`` (``ops/vq.py``). :func:`span` is
defined in ``ops/span.py``, which imports nothing of the port, so that the
quantizer's module stays importable alone.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..ops.span import span

__all__ = ["span", "trace"]


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
