"""ctypes binding and on-demand build of the native ISM library (ism.cpp).

Counterpart of ``acoustic_locating_vq_vae_tpu/native/ism.py``: the same
signature, semantics and error messages, with three differences of the
port's:

* the library is the port's own copy of ``ism.cpp``, built with the JAX
  package's g++ flags (so both give bitwise the same RIRs) into
  ``build/native/`` at the repository root (listed in ``.gitignore``), never
  into the package directory; the file name carries a hash of the source and
  the flags, as ``ops/kernels.py`` names the CUDA libraries, and a build
  writes a temporary file and renames it, under a lock that other processes
  honour too;
* inputs are array-likes or CPU tensors; a CUDA tensor raises rather than
  being copied to the host behind the caller's back;
* the result is a float64 CPU ``torch.Tensor``.

Where the first build fails, it is retried once without ``-march=native``
and OpenMP, as the JAX package does; :func:`num_threads` then reports 1.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["generate_rir_native", "is_available", "num_threads", "build", "library_path", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().with_name("ism.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
FALLBACK_FLAGS = ("-O3", "-shared", "-fPIC")  # the JAX package's retry: no OpenMP, no -march

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path(flags: Sequence[str] = FLAGS) -> Path:
    """Where the library built from ``ism.cpp`` with ``flags`` lies."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ism-{digest}.so"


def _compile(flags: Sequence[str], force: bool) -> str:
    out = library_path(flags)
    if out.exists() and not force:
        return str(out)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # a reader never sees half a library
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


def build(force: bool = False) -> str:
    """Compile ism.cpp with g++ (OpenMP when available) unless it is built;
    returns the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _compile(FLAGS, force)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return _compile(FALLBACK_FLAGS, force)


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native ISM unavailable: {_build_error}")
        try:
            lib = ctypes.CDLL(build())
        except Exception as e:  # toolchain missing / build failed
            _build_error = str(e)
            raise RuntimeError(f"native ISM unavailable: {e}") from e
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.ism_generate.restype = ctypes.c_int
        lib.ism_generate.argtypes = [
            dptr, ctypes.c_int, dptr, dptr, dptr, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dptr,
        ]
        lib.ism_num_threads.restype = ctypes.c_int
        lib.ism_num_threads.argtypes = []
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def num_threads() -> int:
    """The OpenMP threads a call uses; 1 for a build without OpenMP."""
    return int(_load().ism_num_threads())


def _host(a, name: str):
    """``a`` as an array-like on the host; a tensor must already be there."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} lies on {a.device}: the native ISM library runs on the host and takes CPU "
                             "tensors or arrays; move it with .cpu() first")
        return a.detach().numpy()
    return a


def generate_rir_native(
    sources,
    receiver: Sequence[float],
    room: Sequence[float],
    nsample: int,
    fs: float,
    rt60: Optional[float] = None,
    beta: Union[None, float, Sequence[float]] = None,
    c: float = 340.0,
    order: int = -1,
    hp: bool = True,
) -> torch.Tensor:
    """Batched host-side RIR synthesis. ``sources``: (B, 3) or (3,) meters.
    Returns (B, nsample), or (nsample,) for one source, float64 on the CPU.
    Same argument semantics as dsp.generate_rir (and rir.generate of the
    reference's pip package)."""
    from ..dsp.rir import beta_from_rt60

    sources, receiver, room, beta = (_host(a, n) for a, n in ((sources, "sources"), (receiver, "receiver"),
                                                              (room, "room"), (beta, "beta")))
    if (rt60 is None) == (beta is None):
        raise ValueError("specify exactly one of rt60 / beta")
    if beta is None:
        beta6 = np.full(6, beta_from_rt60(room, rt60, c))
    elif np.ndim(beta) == 0:
        beta6 = np.full(6, float(beta))
    else:
        beta6 = np.asarray(beta, np.float64)
        if beta6.shape != (6,):
            raise ValueError("beta must be scalar or length-6")

    src = np.ascontiguousarray(np.atleast_2d(np.asarray(sources, np.float64)))
    if src.shape[1] != 3:
        raise ValueError(f"sources must be (B, 3), got {src.shape}")
    recv = np.ascontiguousarray(np.asarray(receiver, np.float64))
    rm = np.ascontiguousarray(np.asarray(room, np.float64))
    out = np.zeros((src.shape[0], nsample), np.float64)

    lib = _load()
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.ism_generate(
        dptr(src), src.shape[0], dptr(recv), dptr(rm),
        dptr(np.ascontiguousarray(beta6)), float(c), float(fs),
        int(nsample), int(order), int(bool(hp)), dptr(out),
    )
    if rc != 0:
        raise RuntimeError(f"ism_generate failed with code {rc}")
    out = torch.from_numpy(out)
    return out[0] if np.ndim(sources) == 1 else out
