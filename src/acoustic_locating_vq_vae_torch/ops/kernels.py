"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes``. The build
happens at first use, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``); the library's file name carries a hash of its source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "nvcc_command", "library_path", "build_all", "library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
# -Xptxas -v makes the build log report each kernel's registers, shared
# memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("vq_nearest.cu", "vq_codebook_accum.cu", "rir_taps.cu")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def nvcc_command(source: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together. Returns the compiler's output by source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    logs = {}
    try:
        for source in sources:
            out = library_path(source)
            if out.exists():
                continue
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                nvcc_command(source, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
            jobs[source] = (proc, tmp, out)
        for source, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: a reader never sees half a library
            logs[source] = log
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    path = library_path(source)
    if not path.exists():
        build_all((source,))
    return ctypes.CDLL(str(path))
