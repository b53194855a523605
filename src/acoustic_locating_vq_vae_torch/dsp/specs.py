"""Spectrogram-domain feature math.

Counterpart of ``acoustic_locating_vq_vae_tpu/dsp/specs.py``: the RIR
spectral ratio and the Wiener estimate of the data pipeline
(genereate_dataset.py:41-46), the per-batch normalization the reference
trainers share (e.g. scripts/train_speech.py:63-64) and the source position
from an angle.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["rir_spec_ratio", "source_coordinates", "wiener_estimate", "znorm"]


def rir_spec_ratio(speech_spec: torch.Tensor, echoed_spec: torch.Tensor) -> torch.Tensor:
    """Complex spectral ratio ``speech / (echoed + 1e-8)`` divided by its
    largest magnitude over the last two axes (F, T), so each sample of a
    (..., F, T) batch is normalized by its own maximum, as the JAX pipeline's
    ``vmap`` over samples does (genereate_dataset.py:41-42)."""
    ratio = speech_spec / (echoed_spec + 1e-8)
    return ratio / torch.amax(torch.abs(ratio), dim=(-2, -1), keepdim=True)


def wiener_estimate(speech_spec: torch.Tensor, echoed_spec: torch.Tensor) -> torch.Tensor:
    """Per-frequency Wiener transfer-function estimate, magnitude squared:
    ``|sum_t(echoed * conj(speech)) / (sum_t |speech|^2 + 1e-8)|^2``
    (genereate_dataset.py:44-46). (..., F, T) -> (..., F)."""
    num = torch.sum(echoed_spec * torch.conj(speech_spec), dim=-1)
    den = torch.sum(speech_spec * torch.conj(speech_spec), dim=-1) + 1e-8
    return torch.abs(num / den) ** 2


def znorm(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize along ``dim`` with the unbiased std (ddof = 1) and ``eps``
    added to the std: ``(x - x.mean(dim)) / (x.std(dim) + 1e-8)``, as in
    train_speech.py:64."""
    mean = torch.mean(x, dim=dim, keepdim=True)
    n = x.shape[dim]
    var = torch.sum((x - mean) ** 2, dim=dim, keepdim=True) / max(n - 1, 1)
    return (x - mean) / (torch.sqrt(var) + eps)


def source_coordinates(
    theta: torch.Tensor,
    receiver_position: Union[torch.Tensor, Sequence[float]],
    room_dimensions: Union[torch.Tensor, Sequence[float]],
    radius: Union[torch.Tensor, float] = 1.0,
    z_loc: float = 1.0,
) -> torch.Tensor:
    """3-D source position on a circle of ``radius`` around the receiver,
    clipped to the room's upper walls only (genereate_dataset.py:16-20).
    ``theta``: (...,) -> (..., 3)."""
    radius = torch.as_tensor(radius, dtype=theta.dtype, device=theta.device)
    offs = torch.stack(
        [radius * torch.cos(theta), radius * torch.sin(theta), torch.full_like(theta, z_loc)],
        dim=-1,
    )
    receiver = torch.as_tensor(receiver_position, dtype=theta.dtype, device=theta.device)
    room = torch.as_tensor(room_dimensions, dtype=theta.dtype, device=theta.device)
    return torch.minimum(receiver + offs, room)
