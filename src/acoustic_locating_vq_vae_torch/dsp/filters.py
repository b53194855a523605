"""FFT convolution and the image-source method's high-pass filter.

Counterpart of ``acoustic_locating_vq_vae_tpu/dsp/filters.py:19-83``. The
reference convolves speech with a RIR by ``scipy.signal.convolve(waveform,
h_RIR, 'same')`` (genereate_dataset.py:38); here it is one batched FFT
convolution (cuFFT on the card). The high-pass is the Habets rir-generator's
100 Hz post filter, computed as the JAX package does: the closed-form impulse
response of its AR part, its MA taps applied analytically, then an FFT
convolution. Both follow the floating dtype of their input.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fft_convolve", "highpass_habets"]


def fft_convolve(x: torch.Tensor, h: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """Linear convolution of ``x`` (..., N) with ``h`` (..., M) along the last
    axis, leading dimensions broadcast. Output selection as
    ``scipy.signal.convolve``: ``full`` is N+M-1 long, ``same`` N (centered),
    ``valid`` max(N, M) - min(N, M) + 1."""
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode {mode!r}")
    n, m = x.shape[-1], h.shape[-1]
    full = n + m - 1
    fft_len = 1 << (full - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, fft_len) * torch.fft.rfft(h, fft_len), fft_len)[..., :full]
    if mode == "full":
        return y
    if mode == "same":
        start = (m - 1) // 2
        return y[..., start : start + n]
    out_len = max(n, m) - min(n, m) + 1
    return y[..., min(n, m) - 1 : min(n, m) - 1 + out_len]


def highpass_habets(x: torch.Tensor, fs: int) -> torch.Tensor:
    """The rir-generator's 100 Hz post high-pass of ``x`` (..., N), the
    causal filter

        y[n]   = x[n] + B1*y[n-1] + B2*y[n-2]
        out[n] = y[n] + A1*y[n-1] + R1*y[n-2]

    as the closed-form AR impulse response ``R1^n sin((n+1)W) / sin(W)`` with
    the MA taps applied to it, FFT-convolved with ``x`` and cut to N. A
    float32 input is filtered in float32, as the JAX package does; a float64
    one in float64."""
    dtype = x.dtype if x.dtype == torch.float64 else torch.float32
    w = torch.full((), 2.0 * math.pi * 100.0 / fs, dtype=dtype, device=x.device)
    r1 = torch.exp(-w)
    a1 = -(1.0 + r1)
    n = x.shape[-1]
    m = torch.arange(n, dtype=dtype, device=x.device)
    h_ar = torch.exp(m * torch.log(r1)) * torch.sin((m + 1.0) * w) / torch.sin(w)
    zeros = torch.zeros(2, dtype=dtype, device=x.device)
    h_full = h_ar + a1 * torch.cat([zeros[:1], h_ar[:-1]]) + r1 * torch.cat([zeros, h_ar[:-2]])
    out = fft_convolve(x.to(dtype), h_full, mode="full")[..., :n]
    return out.to(x.dtype)
