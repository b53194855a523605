"""Device rules, checkpoints and the stage store, profiling, visualization."""

from .checkpoint import StageStore, load_state, save_state
from .device import deterministic_convs, full_fp32, resolve_device, static_tensor
from .profiling import span, trace
from .viz import plot_spectrogram, plot_spectrogram_grid

__all__ = [
    "StageStore", "deterministic_convs", "full_fp32", "load_state", "plot_spectrogram", "plot_spectrogram_grid",
    "resolve_device", "save_state", "span", "static_tensor", "trace",
]
