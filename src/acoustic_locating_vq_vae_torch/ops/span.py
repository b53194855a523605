"""The program's span helper, :func:`span` (documented and exported by
``utils/profiling.py``). It lives here, importing nothing of the port, so
that ``ops.vq``, which a loaded artifact imports alone, can use it."""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` annotation while a profiler records,
    else a shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
