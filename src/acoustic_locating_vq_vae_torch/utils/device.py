"""Device rules shared by the port's entry points: the device a caller asks
for, the float32 precision of convolutions and matrix products, and static
values kept on the device."""

from __future__ import annotations

import contextlib
import functools
from typing import Union

import torch

__all__ = ["deterministic_convs", "full_fp32", "resolve_device", "static_tensor"]


@functools.lru_cache(maxsize=64)
def static_tensor(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of static ``values`` on ``device``, copied there once and
    shared by every caller, who must not write to it (a copy from pageable
    host memory waits for the card)."""
    return torch.tensor(values, dtype=dtype).to(device)


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matrix products in full float32.

    cuDNN runs float32 convolutions in TF32 by default. The pre-VQ latent
    decides the argmin, and reduced-precision products flip near-tie codes
    (the JAX package's ops/vq.py:57-60), so serving and training keep TF32
    off for both cuDNN and cuBLAS. The previous settings come back on exit."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_convs():
    """Restrict cuDNN to deterministic convolution algorithms.

    Training uses it so that a step is bitwise reproducible from the same
    weights, batch and jitter decisions, as the JAX package's steps are and
    as resuming a run from a checkpoint needs (chip_smoke.py phase 6 checks
    it; phase 7 times the step without it). The previous setting comes back
    on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but torch.cuda.is_available() is False")
    return device
