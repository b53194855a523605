"""Device rules, checkpoints and the stage store, profiling."""

from .checkpoint import StageStore, load_state, save_state
from .device import deterministic_convs, full_fp32, resolve_device
from .profiling import StepTimer, time_fn, trace

__all__ = [
    "StageStore", "StepTimer", "deterministic_convs", "full_fp32", "load_state", "resolve_device",
    "save_state", "time_fn", "trace",
]
