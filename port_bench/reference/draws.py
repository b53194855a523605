"""The random inputs of an on-the-fly batch, worked out again from the seed
of the generator that the program's trainer synthesizes from.

A frozen copy of the draw order of the port's ``data/synth.py:draw_synthesis``
with its default options (the reference generator's fixed geometry: no T60
or radius range, no sensor noise, no bank, the synthetic speech), and of its
synthetic speech (``data/speech.py:speech_draws``, ``speech_from_draws``):
angle, T60, radius, SNR and clean-mask uniforms, the sensor noise, then the
speech's draws. The speech is the input signal of the synthesis, so it is
made in float32, as the program makes it; everything after it, the RIR, the
convolution and the STFT (``synth.py``), is the reference's in float64.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

N_HARMONICS = 12


def _speech_draws(gen: torch.Generator, batch: int, num_samples: int, fs: int) -> Dict[str, torch.Tensor]:
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    n_ctrl = max(2, int(num_samples / fs * 8))
    return {
        "f0_base": uniform((batch, 1), 90.0, 240.0),
        "wander_rate": uniform((batch, 1), 0.5, 3.0),
        "wander_phase": uniform((batch, 1), 0.0, 2 * math.pi),
        "noise": torch.randn((batch, num_samples), generator=gen, device=dev) * 0.5,
        "energy_ctrl": uniform((batch, n_ctrl), 0.05, 1.0),
        "voicing_ctrl": uniform((batch, n_ctrl), 0.0, 1.0),
        "centers": uniform((batch, 3, 1), 300.0, 3400.0),
        "bandwidths": uniform((batch, 3, 1), 80.0, 300.0),
    }


def _envelope(ctrl: torch.Tensor, num_samples: int) -> torch.Tensor:
    n_ctrl = ctrl.shape[-1]
    dt, dev = ctrl.dtype, ctrl.device
    stop = float(num_samples - 1)
    xp = torch.cat([stop * (torch.arange(n_ctrl - 1, dtype=dt, device=dev) / (n_ctrl - 1)),
                    torch.full((1,), stop, dtype=dt, device=dev)])
    x = torch.arange(num_samples, dtype=dt, device=dev)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n_ctrl - 1)
    return ctrl[:, i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (ctrl[:, i] - ctrl[:, i - 1])


def _speech(d: Dict[str, torch.Tensor], fs: int) -> torch.Tensor:
    """Unit-peak source-filter waveforms (B, N) of the speech draws."""
    noise = d["noise"]
    dt, dev = noise.dtype, noise.device
    n = noise.shape[-1]
    t = torch.arange(n, dtype=dt, device=dev) / fs
    f0 = d["f0_base"] * (1.0 + 0.08 * torch.sin(2 * math.pi * d["wander_rate"] * t + d["wander_phase"]))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / fs
    voiced = torch.zeros_like(phase)
    for h in range(1, N_HARMONICS + 1):
        voiced = voiced + torch.sin(h * phase) / h
    energy = _envelope(d["energy_ctrl"], n) ** 2
    voicing = _envelope(d["voicing_ctrl"], n)
    excitation = energy * (voicing * voiced + (1.0 - voicing) * noise)
    freqs = torch.arange(n // 2 + 1, dtype=dt, device=dev) / (n * (1.0 / fs))
    resp = torch.sum(1.0 / (1.0 + ((freqs - d["centers"]) / d["bandwidths"]) ** 2), dim=1)
    tilt = 1.0 / (1.0 + (freqs / 2000.0) ** 2)
    wave = torch.fft.irfft(torch.fft.rfft(excitation, dim=1) * (0.2 + resp) * tilt, n=n, dim=1)
    return wave / (torch.amax(torch.abs(wave), dim=1, keepdim=True) + 1e-8)


def fixed_geometry_draws(gen: torch.Generator, batch: int, geometry: dict) -> Dict[str, torch.Tensor]:
    """One batch's draws (theta, radius, rt60, speech, r_hi) from ``gen``,
    in the order and precision the program draws them."""
    dev = gen.device
    u_theta = -math.pi + 2 * math.pi * torch.rand(batch, generator=gen, device=dev)
    for _ in range(4):  # T60, radius, SNR and clean-mask uniforms: drawn, unused at the fixed geometry
        torch.rand(batch, generator=gen, device=dev)
    n, fs = int(geometry["audio_samples"]), int(geometry["fs"])
    torch.randn((batch, n), generator=gen, device=dev)  # the sensor noise, unused without an SNR range
    speech = _speech(_speech_draws(gen, batch, n, fs), fs)
    r = float(geometry["R"])
    return {"theta": u_theta, "radius": torch.full((batch,), r, device=dev), "rt60": None, "speech": speech,
            "snr_db": None, "noise": None, "clean": None, "r_hi": r}
