"""STFT, inverse STFT and Griffin-Lim: the pipeline's spectrogram frontend.

Counterpart of ``acoustic_locating_vq_vae_tpu/dsp/stft.py:40-216``, which
replaces the reference's ``torchaudio.transforms.Spectrogram(n_fft=400,
hop_length=160, power=None, center=True, pad=0, normalized=True)``
(genereate_dataset.py:90-91). Semantics:

  * ``center=True`` reflect padding, as ``torch.stft``;
  * the periodic Hann window;
  * ``normalized=True`` is torchaudio's ``"window"`` mode: the complex STFT
    divided by ``sqrt(sum(window**2))``. ``torch.stft(normalized=True)``
    divides by ``sqrt(n_fft)`` instead (a factor of 2.67 in power at n_fft =
    400), so the STFT here runs unnormalized and scales itself;
  * the one-sided spectrum, layout (..., F = n_fft//2 + 1, T).

The transforms run through ``torch.stft`` / ``torch.fft`` (cuFFT on the card)
and the overlap-add through ``F.fold``; none uses atomics.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

__all__ = [
    "griffin_lim",
    "griffin_lim_from_angle",
    "hann_window",
    "inverse_spectrogram",
    "istft",
    "power_to_db",
    "spectrogram",
    "stft",
]

Norm = Union[bool, str]


def hann_window(win_length: int, periodic: bool = True, dtype=torch.float32, device=None) -> torch.Tensor:
    """Hann window as the JAX package computes it; ``periodic=True`` is
    ``torch.hann_window``'s default."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(n, dtype=dtype, device=device) / (n - 1)))
    return w[:win_length] if periodic else w


def _norm_scale(window: torch.Tensor, n_fft: int, normalized: Norm) -> Optional[torch.Tensor]:
    if normalized is True or normalized == "window":
        return torch.sqrt(torch.sum(window**2))
    if normalized == "frame_length":
        return torch.full((), math.sqrt(n_fft), dtype=window.dtype, device=window.device)
    return None


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    normalized: Norm = False,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex one-sided STFT of ``x`` (..., L) -> (..., F, T), normalized as
    torchaudio (``True`` or ``"window"``: by ``sqrt(sum(window**2))``;
    ``"frame_length"``: by ``sqrt(n_fft)``)."""
    if window is None:
        window = hann_window(n_fft, dtype=x.dtype, device=x.device)
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop_length, win_length=n_fft, window=window,
        center=center, pad_mode=pad_mode, normalized=False, onesided=True, return_complex=True,
    )
    scale = _norm_scale(window, n_fft, normalized)
    if scale is not None:
        spec = spec / scale
    return spec.reshape(lead + spec.shape[-2:])


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    normalized: Norm = False,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse of :func:`stft` by windowed overlap-add, divided by the summed
    squared window (floored at 1e-11). ``spec``: (..., F, T) complex."""
    real = spec.real.dtype
    if window is None:
        window = hann_window(n_fft, dtype=real, device=spec.device)
    scale = _norm_scale(window, n_fft, normalized)
    if scale is not None:
        spec = spec * scale
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window  # (..., T, n_fft)
    lead, num_frames = frames.shape[:-2], frames.shape[-2]
    out_len = (num_frames - 1) * hop_length + n_fft

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:  # (N, n_fft, T) -> (N, out_len)
        return F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop_length)).reshape(cols.shape[0], out_len)

    y = overlap_add(frames.reshape(-1, num_frames, n_fft).transpose(1, 2))
    wsq = overlap_add((window**2)[None, :, None].expand(1, n_fft, num_frames).contiguous())
    y = y / torch.clamp(wsq, min=1e-11)
    if center:
        y = y[:, n_fft // 2 : out_len - n_fft // 2]
    if length is not None:
        y = y[:, :length]
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y.reshape(lead + y.shape[-1:])


def spectrogram(
    x: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    power: Optional[float] = None,
    normalized: Norm = True,
    center: bool = True,
) -> torch.Tensor:
    """``torchaudio.transforms.Spectrogram``: the complex STFT for
    ``power=None``, else ``|STFT| ** power``."""
    spec = stft(x, n_fft=n_fft, hop_length=hop_length, center=center, normalized=normalized)
    return spec if power is None else torch.abs(spec) ** power


def inverse_spectrogram(
    spec: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    normalized: Norm = True,
    center: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """``torchaudio.transforms.InverseSpectrogram`` of a complex spectrogram."""
    return istft(spec, n_fft=n_fft, hop_length=hop_length, center=center, normalized=normalized, length=length)


def griffin_lim(
    magnitude: torch.Tensor,
    generator: torch.Generator,
    n_fft: int = 400,
    hop_length: int = 160,
    n_iter: int = 32,
    power: float = 2.0,
    momentum: float = 0.99,
    normalized: Norm = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Griffin-Lim phase recovery from a (power) spectrogram (..., F, T)
    (the reference's resynthesis path, sout_test.py:25-30): a uniform random
    initial phase drawn from ``generator``, then :func:`griffin_lim_from_angle`."""
    angle = torch.rand(magnitude.shape, generator=generator, device=generator.device, dtype=magnitude.dtype)
    angle = (angle * (2.0 * math.pi)).to(magnitude.device)
    return griffin_lim_from_angle(magnitude, angle, n_fft, hop_length, n_iter, power, momentum, normalized, length)


def griffin_lim_from_angle(
    magnitude: torch.Tensor,
    angle: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    n_iter: int = 32,
    power: float = 2.0,
    momentum: float = 0.99,
    normalized: Norm = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Griffin-Lim with momentum from the initial phase ``angle``, as the
    JAX package's loop body (``stft.py:183-197``)."""
    mag = magnitude ** (1.0 / power)
    spec = mag * torch.exp(1j * angle)
    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        y = istft(spec, n_fft=n_fft, hop_length=hop_length, normalized=normalized, length=length)
        rebuilt = stft(y, n_fft=n_fft, hop_length=hop_length, normalized=normalized)
        update = rebuilt - (momentum / (1.0 + momentum)) * prev
        phase = update / torch.clamp(torch.abs(update), min=1e-16)
        spec, prev = mag * phase[..., : mag.shape[-1]], rebuilt
    return istft(spec, n_fft=n_fft, hop_length=hop_length, normalized=normalized, length=length)


def power_to_db(s: torch.Tensor, ref: float = 1.0, amin: float = 1e-10, top_db: Optional[float] = 80.0) -> torch.Tensor:
    """``librosa.power_to_db`` (visualization.py:15)."""
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, torch.max(log_spec) - top_db)
    return log_spec
