"""Native (C++) runtime components, on the host.

``ism``: host-side image-source RIR synthesis in float64, the C++
counterpart of the torch op in dsp/rir.py (see ism.cpp) and its oracle.
Compiled on first use with g++ into ``build/native/`` and bound via ctypes;
raises a clear error when no toolchain is present. It is host C++, not a
kernel of the card."""

from .ism import build, generate_rir_native, is_available, num_threads

__all__ = ["build", "generate_rir_native", "is_available", "num_threads"]
