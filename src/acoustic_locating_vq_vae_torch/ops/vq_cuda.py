"""Wrappers of the hand-written vector-quantizer kernels.

* ``nearest_indices_cuda`` (``csrc/vq_nearest.cu``): counterpart of the
  Pallas ``_fwd_kernel`` / ``_fwd_impl`` in
  ``acoustic_locating_vq_vae_tpu/ops/vq_pallas.py``. The kernel returns the
  int32 code ids and each row's winning float32 score (which a codebook split
  over ranks merges across its shards); ``ops/vq.py`` adds the row norms
  before the call and the row gather after it, as ``_fwd_impl`` does around
  its ``pallas_call``. Plain version: ``ops.vq.nearest_scored``.
* ``codebook_grad_cuda`` and ``codebook_stats_cuda``
  (``csrc/vq_codebook_accum.cu``): counterparts of the Pallas ``_bwd_kernel``
  as ``_dcb_impl`` (the codebook gradient) and ``codebook_stats_pallas`` (the
  EMA counts and sums) drive it. Plain versions: ``ops.vq.codebook_grad`` and
  ``ops.vq.codebook_stats`` on CPU tensors.

Each wrapper's ``.launches`` counts its kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .kernels import library

__all__ = ["nearest_indices_cuda", "codebook_grad_cuda", "codebook_stats_cuda"]


@functools.cache
def _launcher():
    fn = library("vq_nearest.cu").vq_nearest_launch
    # pointers and the stream as c_void_p: an undeclared argument would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _accum_launcher():
    fn = library("vq_codebook_accum.cu").vq_codebook_accum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on(device: torch.device):
    """The device to launch on: entered only where it is not the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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


def nearest_indices_cuda(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor):
    """``(idx, score)``: ``argmin_k (e2[k] - 2 flat_x[n] . codebook[k])`` per
    row, first index on ties, as int32 ``(N,)``, and that least score as
    float32 ``(N,)`` (+inf on a row whose every score is NaN or +inf, which
    takes code 0). ``e2`` holds the codebook's squared row norms. A code's
    score does not depend on how the codebook is split: the same rows give
    bitwise the same scores in any codebook they are part of. Launches on the
    current stream and does not synchronise."""
    _check(flat_x, codebook, e2)
    n, d = flat_x.shape
    k = codebook.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=flat_x.device)
    score = torch.empty(n, dtype=torch.float32, device=flat_x.device)
    with _on(flat_x.device):
        err = _launcher()(
            flat_x.data_ptr(), codebook.data_ptr(), e2.data_ptr(), idx.data_ptr(), score.data_ptr(),
            n, k, d, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"vq_nearest kernel launch failed with CUDA error {err}")
    nearest_indices_cuda.launches += 1
    return idx, score


nearest_indices_cuda.launches = 0


def _check_accum(idx: torch.Tensor, g: torch.Tensor, k: int) -> None:
    for name, t in (("idx", idx), ("g", g)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.device != g.device:
        raise ValueError(f"idx is on {idx.device}, g on {g.device}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    if idx.dim() != 1 or g.dim() != 2 or g.shape[0] != idx.shape[0]:
        raise ValueError(f"need idx (N,) and g (N, D), got {tuple(idx.shape)}, {tuple(g.shape)}")
    n, d = g.shape
    if n < 1 or k < 1 or d < 1:
        raise ValueError(f"need N, K, D >= 1, got N={n}, K={k}, D={d}")
    if n >= 2**31 or k * d >= 2**31:
        raise ValueError("N and K * D must fit in int32")


def _accumulate(idx: torch.Tensor, g: torch.Tensor, k: int, with_counts: bool):
    n, d = g.shape
    if with_counts:  # one allocation holds the sums and, behind them, the counts
        buf = torch.empty(k * d + k, dtype=torch.float32, device=g.device)
        out, counts = buf[: k * d].view(k, d), buf[k * d:]
    else:
        out, counts = torch.empty(k, d, dtype=torch.float32, device=g.device), None
    with _on(g.device):
        err = _accum_launcher()(
            idx.data_ptr(), g.data_ptr(), out.data_ptr(),
            counts.data_ptr() if with_counts else None,
            n, k, d, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"vq_codebook_accum kernel launch failed with CUDA error {err}")
    return out, counts


def codebook_grad_cuda(idx: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """``out[c] = sum of g[n] over rows with idx[n] == c``, ``(K, D)`` float32:
    the codebook gradient ``one_hot(idx)^T @ g``. Indices outside ``[0, K)``
    add nothing. Deterministic; launches on the current stream."""
    _check_accum(idx, g, k)
    out, _ = _accumulate(idx, g, k, with_counts=False)
    codebook_grad_cuda.launches += 1
    return out


codebook_grad_cuda.launches = 0


def codebook_stats_cuda(idx: torch.Tensor, x: torch.Tensor, k: int):
    """Per-code usage counts ``(K,)`` float32 and row sums ``(K, D)`` in one
    launch: the EMA codebook's statistics. Indices outside ``[0, K)`` add
    nothing. Deterministic; launches on the current stream."""
    _check_accum(idx, x, k)
    sums, counts = _accumulate(idx, x, k, with_counts=True)
    codebook_stats_cuda.launches += 1
    return counts, sums


codebook_stats_cuda.launches = 0
