"""Device rules shared by the entry points."""

from .device import deterministic_convs, full_fp32, resolve_device

__all__ = ["deterministic_convs", "full_fp32", "resolve_device"]
