"""Wrapper of the hand-written nearest-codebook kernel (``csrc/vq_nearest.cu``).

Counterpart of the Pallas ``_fwd_kernel`` / ``_fwd_impl`` in
``acoustic_locating_vq_vae_tpu/ops/vq_pallas.py``. The kernel returns only the
int32 code ids; ``ops/vq.py`` adds the row norms before the call and the row
gather after it, as ``_fwd_impl`` does around its ``pallas_call``. The plain
PyTorch version of the same function is ``ops.vq.nearest_indices``.

``nearest_indices_cuda.launches`` counts the kernel's launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .kernels import library

__all__ = ["nearest_indices_cuda"]


@functools.cache
def _launcher():
    fn = library("vq_nearest.cu").vq_nearest_launch
    # pointers and the stream as c_void_p: an undeclared argument would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> None:
    for name, t in (("flat_x", flat_x), ("codebook", codebook), ("e2", e2)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != flat_x.device:
            raise ValueError(f"{name} is on {t.device}, flat_x on {flat_x.device}")
    if flat_x.dim() != 2 or codebook.dim() != 2:
        raise ValueError(f"flat_x and codebook must be 2-D, got {tuple(flat_x.shape)}, {tuple(codebook.shape)}")
    n, d = flat_x.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"feature widths differ: flat_x has {d}, codebook {codebook.shape[1]}")
    if tuple(e2.shape) != (k,):
        raise ValueError(f"e2 must have shape ({k},), got {tuple(e2.shape)}")
    if n < 1 or k < 1 or d < 1:
        raise ValueError(f"need N, K, D >= 1, got N={n}, K={k}, D={d}")
    if n >= 2**31 or k >= 2**31:
        raise ValueError("N and K must fit in int32")


def nearest_indices_cuda(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """``argmin_k (e2[k] - 2 flat_x[n] . codebook[k])`` per row, first index on
    ties, as int32 ``(N,)``. ``e2`` holds the codebook's squared row norms.
    Launches on the current stream and does not synchronise."""
    _check(flat_x, codebook, e2)
    n, d = flat_x.shape
    k = codebook.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=flat_x.device)
    with torch.cuda.device(flat_x.device):
        launch = _launcher()
        err = launch(
            flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr(),
            n, k, d, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"vq_nearest kernel launch failed with CUDA error {err}")
    nearest_indices_cuda.launches += 1
    return idx


nearest_indices_cuda.launches = 0
