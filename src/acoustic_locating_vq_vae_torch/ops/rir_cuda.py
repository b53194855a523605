"""Wrapper of the hand-written image-source tap kernel.

``rir_taps_cuda`` (``csrc/rir_taps.cu``) builds the unfiltered room impulse
responses of a batch of sources from the static plan of
``dsp/rir.py:_tap_plan``. It replaces no Pallas kernel: the JAX package lowers
the tap build through XLA (``dsp/rir.py``'s ``one_hot(block)ᵀ @ taps``), and
the port's eager version of that tensor program moved hundreds of bytes of
device memory per tap. Plain version: ``dsp/rir.py:_block_matmul`` on CPU
tensors.

The main path reaches it through the registered operator ``rir_taps``
(``dsp/rir.py``; ``torch.ops.acoustic_locating_vq_vae_torch.rir_taps``), CUDA
only: a CPU tensor has no kernel here, and ``dsp.generate_rir_batch`` takes
the plain version for it. The wrapper's ``.launches`` counts its launches, and
``.rows`` the lattice rows they walked for one source (a row counted once in
each segment's list that holds it).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List

import torch

from .kernels import library

__all__ = ["rir_taps_cuda"]

_MAX_SEG = 256  # the kernel's block is one thread per output sample of a segment


@functools.cache
def _launcher():
    fn = library("rir_taps.cu").rir_taps_launch
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6 + [ctypes.c_double] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _on(device: torch.device):
    """The device to launch on: entered only where it is not the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check(sources, receiver, betas, entries, slot_ptr, slot_seg, table, nsample: int, seg: int, max_pow: int):
    named = (("sources", sources), ("receiver", receiver), ("betas", betas), ("entries", entries),
             ("slot_ptr", slot_ptr), ("slot_seg", slot_seg), ("table", table))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
        if t.device != sources.device:
            raise ValueError(f"{name} is on {t.device}, sources on {sources.device}")
        if name != "betas" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sources.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sources must be float32 or float64, got {sources.dtype}")
    for name, t in (("receiver", receiver), ("betas", betas), ("table", table)):
        if t.dtype != sources.dtype:
            raise ValueError(f"{name} must be {sources.dtype} as the sources, got {t.dtype}")
    for name, t in (("entries", entries), ("slot_ptr", slot_ptr), ("slot_seg", slot_seg)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    batch = sources.shape[0]
    if sources.dim() != 2 or sources.shape[1] != 3 or batch < 1:
        raise ValueError(f"sources must be (B, 3) with B >= 1, got {tuple(sources.shape)}")
    if tuple(receiver.shape) != (3,):
        raise ValueError(f"receiver must be (3,), got {tuple(receiver.shape)}")
    if tuple(betas.shape) != (batch, 6):
        raise ValueError(f"betas must be ({batch}, 6), got {tuple(betas.shape)}")
    if entries.dim() != 2 or entries.shape[1] != 4:
        raise ValueError(f"entries must be (P, 4), got {tuple(entries.shape)}")
    if not (0 < seg <= _MAX_SEG and seg % 32 == 0):
        raise ValueError(f"seg must be a multiple of 32 in (0, {_MAX_SEG}], got {seg}")
    if not 0 < nsample < 2**30:
        raise ValueError(f"nsample must lie in (0, 2**30), got {nsample}")
    n_seg = -(-nsample // seg)
    if tuple(slot_seg.shape) != (n_seg,) or tuple(slot_ptr.shape) != (n_seg + 1,) or n_seg > 65535:
        raise ValueError(f"{nsample} samples in segments of {seg} need slot_seg ({n_seg},) and slot_ptr "
                         f"({n_seg + 1},) with at most 65535 segments, got {tuple(slot_seg.shape)}, "
                         f"{tuple(slot_ptr.shape)}")
    if table.dim() != 2 or table.shape[0] != 2 or table.shape[1] < 3:
        raise ValueError(f"table must be (2, tw + 1) with tw >= 2, got {tuple(table.shape)}")
    if max_pow < 1 or batch >= 2**31 or entries.shape[0] >= 2**31:
        raise ValueError(f"need max_pow >= 1 and B, P below 2**31, got {max_pow}, {batch}, {entries.shape[0]}")


def rir_taps_cuda(sources: torch.Tensor, receiver: torch.Tensor, betas: torch.Tensor, entries: torch.Tensor,
                  slot_ptr: torch.Tensor, slot_seg: torch.Tensor, table: torch.Tensor, nsample: int, seg: int,
                  max_pow: int, room: List[float], c_ts: float) -> torch.Tensor:
    """The unfiltered RIRs ``(B, nsample)`` of ``sources`` ``(B, 3)`` in
    meters for ``receiver`` ``(3,)``, in the sources' dtype (float32 or
    float64), each output sample summed in float64 in the plan's order.

    ``betas`` ``(B, 6)``, any strides (an expanded view of six or of B
    values): each source's wall reflection coefficients. The plan
    (``dsp/rir.py:_card_plan``): ``entries``, ``slot_ptr``, ``slot_seg``,
    ``seg`` samples a segment, ``max_pow``; ``table`` ``(2, tw + 1)`` holds
    cos and sin of ``2 pi n / tw``. ``room`` is the room in samples, ``c_ts``
    the metres a sample. Launches on the current stream and does not
    synchronise."""
    _check(sources, receiver, betas, entries, slot_ptr, slot_seg, table, nsample, seg, max_pow)
    batch, tw = sources.shape[0], table.shape[1] - 1
    out = torch.empty(batch, nsample, dtype=sources.dtype, device=sources.device)
    with _on(sources.device):
        err = _launcher()(
            int(sources.dtype == torch.float64), sources.data_ptr(), receiver.data_ptr(), betas.data_ptr(),
            betas.stride(0), betas.stride(1), entries.data_ptr(), slot_ptr.data_ptr(), slot_seg.data_ptr(),
            table.data_ptr(), out.data_ptr(), batch, nsample, tw, seg, slot_seg.shape[0], max_pow,
            float(room[0]), float(room[1]), float(room[2]), float(c_ts), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"rir_taps kernel launch failed with CUDA error {err}")
    rir_taps_cuda.launches += 1
    rir_taps_cuda.rows += int(entries.shape[0])
    return out


rir_taps_cuda.launches = 0
rir_taps_cuda.rows = 0
