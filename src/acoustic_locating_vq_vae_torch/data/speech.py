"""Speech sources for the synthetic pipeline.

Counterpart of ``acoustic_locating_vq_vae_tpu/data/speech.py:31-113``. The
reference draws LibriSpeech utterances through torchaudio
(genereate_dataset.py:93); the port has two sources:

  * :func:`synthetic_speech_batch`: a source-filter speech surrogate made on
    the device (pitch-contoured harmonic voicing, formant-shaped noise),
    structured enough to train the VQ-VAEs and to measure with; not real
    speech. It is a draw step (:func:`speech_draws`, from a
    ``torch.Generator``) and a deterministic body (:func:`speech_from_draws`),
    so the same draws give the same waveforms on any device;
  * :func:`load_wav_dir`: 16 kHz wavs from a directory (scipy), the corpus
    the CLIs take as ``--wav-dir``; :func:`load_librispeech`: the utterances
    of a LibriSpeech checkout (JAX :115-183), ``.wav`` through scipy and
    ``.flac`` through soundfile where it imports, else the built-in decoder
    (:mod:`.flac`), the corpus the CLIs take as ``--librispeech-dir``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "SpeechDraws", "load_librispeech", "load_wav_dir", "speech_draws", "speech_from_draws", "synthetic_speech_batch",
]

N_HARMONICS = 12


class SpeechDraws(NamedTuple):
    """The random inputs of a batch of B synthetic utterances."""

    f0_base: torch.Tensor  # (B, 1) Hz, U(90, 240)
    wander_rate: torch.Tensor  # (B, 1) Hz, U(0.5, 3)
    wander_phase: torch.Tensor  # (B, 1) rad, U(0, 2 pi)
    noise: torch.Tensor  # (B, N), N(0, 1) * 0.5
    energy_ctrl: torch.Tensor  # (B, n_ctrl), U(0.05, 1)
    voicing_ctrl: torch.Tensor  # (B, n_ctrl), U(0, 1)
    centers: torch.Tensor  # (B, 3, 1) Hz, U(300, 3400)
    bandwidths: torch.Tensor  # (B, 3, 1) Hz, U(80, 300)


def _n_ctrl(num_samples: int, fs: int) -> int:
    return max(2, int(num_samples / fs * 8))  # 8 envelope control points per second


def speech_draws(generator: torch.Generator, batch: int, num_samples: int = 80000, fs: int = 16000) -> SpeechDraws:
    """Draw the random inputs of :func:`speech_from_draws` from ``generator``
    (float32, on the generator's device)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    n_ctrl = _n_ctrl(num_samples, fs)
    return SpeechDraws(
        f0_base=uniform((batch, 1), 90.0, 240.0),
        wander_rate=uniform((batch, 1), 0.5, 3.0),
        wander_phase=uniform((batch, 1), 0.0, 2 * math.pi),
        noise=torch.randn((batch, num_samples), generator=generator, device=dev) * 0.5,
        energy_ctrl=uniform((batch, n_ctrl), 0.05, 1.0),
        voicing_ctrl=uniform((batch, n_ctrl), 0.0, 1.0),
        centers=uniform((batch, 3, 1), 300.0, 3400.0),
        bandwidths=uniform((batch, 3, 1), 80.0, 300.0),
    )


def _smooth_envelope(ctrl: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Linear interpolation of (B, n_ctrl) control points spread evenly over
    [0, num_samples - 1] at every sample, as ``jnp.interp`` over the JAX
    package's ``jnp.linspace`` grid."""
    n_ctrl = ctrl.shape[-1]
    dt, dev = ctrl.dtype, ctrl.device
    stop = float(num_samples - 1)
    xp = torch.cat([stop * (torch.arange(n_ctrl - 1, dtype=dt, device=dev) / (n_ctrl - 1)),
                    torch.full((1,), stop, dtype=dt, device=dev)])
    x = torch.arange(num_samples, dtype=dt, device=dev)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n_ctrl - 1)
    delta = x - xp[i - 1]
    dx = xp[i] - xp[i - 1]
    return ctrl[:, i - 1] + (delta / dx) * (ctrl[:, i] - ctrl[:, i - 1])


def speech_from_draws(draws: SpeechDraws, fs: int = 16000) -> torch.Tensor:
    """(B, N) unit-peak speech-like waveforms from ``draws``, in their dtype
    and on their device. Source-filter construction:

      * voiced excitation: 12 harmonics of a slowly wandering f0 with 1/h
        roll-off; the phase is the float32 (or float64) cumulative sum of f0;
      * unvoiced excitation: the white noise;
      * voicing mix and energy modulated by smooth random envelopes (8
        control points a second);
      * three random formant resonances and a gentle tilt above 2 kHz,
        applied in the frequency domain.
    """
    noise = draws.noise
    dt, dev = noise.dtype, noise.device
    num_samples = noise.shape[-1]
    t = torch.arange(num_samples, dtype=dt, device=dev) / fs
    f0 = draws.f0_base * (1.0 + 0.08 * torch.sin(2 * math.pi * draws.wander_rate * t + draws.wander_phase))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / fs  # (B, N)
    voiced = torch.zeros_like(phase)
    for h in range(1, N_HARMONICS + 1):
        voiced = voiced + torch.sin(h * phase) / h

    energy = _smooth_envelope(draws.energy_ctrl, num_samples) ** 2
    voicing = _smooth_envelope(draws.voicing_ctrl, num_samples)
    excitation = energy * (voicing * voiced + (1.0 - voicing) * noise)

    freqs = torch.arange(num_samples // 2 + 1, dtype=dt, device=dev) / (num_samples * (1.0 / fs))  # rfftfreq
    resp = torch.sum(1.0 / (1.0 + ((freqs - draws.centers) / draws.bandwidths) ** 2), dim=1)
    tilt = 1.0 / (1.0 + (freqs / 2000.0) ** 2)  # about -12 dB/octave above 2 kHz
    spec = torch.fft.rfft(excitation, dim=1) * (0.2 + resp) * tilt
    wave = torch.fft.irfft(spec, n=num_samples, dim=1)
    peak = torch.amax(torch.abs(wave), dim=1, keepdim=True)
    return wave / (peak + 1e-8)


def synthetic_speech_batch(
    generator: torch.Generator, batch: int, num_samples: int = 80000, fs: int = 16000
) -> torch.Tensor:
    """(batch, num_samples) float32 speech-like waveforms on the generator's
    device: :func:`speech_draws` then :func:`speech_from_draws`."""
    return speech_from_draws(speech_draws(generator, batch, num_samples, fs), fs)


def _read_wav(path: str) -> np.ndarray:
    """A wav's samples, integer PCM scaled by its type's maximum."""
    from scipy.io import wavfile

    _, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    return data


def _pool_row(data, num_samples: int) -> np.ndarray:
    """One pool row: float32, mono-mixed, zero-padded or cropped to ``num_samples``."""
    data = np.asarray(data, np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if len(data) < num_samples:
        data = np.pad(data, (0, num_samples - len(data)))
    return data[:num_samples]


def load_wav_dir(path: str, num_samples: int, limit: Optional[int] = None) -> np.ndarray:
    """(n, num_samples) float32 from every wav in ``path``, sorted by name,
    mono-mixed, cropped or zero-padded."""
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(".wav"))
    if limit:
        files = files[:limit]
    out = [_pool_row(_read_wav(os.path.join(path, f)), num_samples) for f in files]
    if not out:
        raise FileNotFoundError(f"no wav files in {path}")
    return np.stack(out)


def load_librispeech(root: str, url: str = "train-clean-100", num_samples: int = 80000,
                     limit: Optional[int] = None) -> np.ndarray:
    """(n, num_samples) float32 speech pool from a LibriSpeech checkout, the
    reference's corpus (genereate_dataset.py:93), without torchaudio. Walks

        <root>/LibriSpeech/<url>/<speaker>/<chapter>/<spk>-<chp>-<utt>.flac

    (or ``<root>/<url>/...``) in path order; ``.wav`` through scipy, ``.flac``
    through soundfile where it imports, else the built-in decoder
    (:func:`.flac.read_flac`, CRC-checked). Each utterance is mono-mixed and
    zero-padded or cropped to ``num_samples``: the pool of
    :func:`load_wav_dir`, for ``make_dataset(speech_pool=...)``."""
    candidates = [os.path.join(root, "LibriSpeech", url), os.path.join(root, url)]
    base = next((c for c in candidates if os.path.isdir(c)), None)
    if base is None:
        raise FileNotFoundError(f"no LibriSpeech split {url!r} under {root!r} (tried {candidates})")
    files = []
    for dirpath, _dirnames, filenames in sorted(os.walk(base)):
        for f in sorted(filenames):
            if f.lower().endswith((".flac", ".wav")):
                files.append(os.path.join(dirpath, f))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no .flac/.wav utterances under {base}")
    try:
        import soundfile  # optional: FLAC through libsndfile
    except ImportError:
        soundfile = None
    out = []
    for path in files:
        if path.lower().endswith(".wav"):
            data = _read_wav(path)
        elif soundfile is not None:
            data, _ = soundfile.read(path, dtype="float32")
        else:
            from .flac import read_flac

            data, _ = read_flac(path)
        out.append(_pool_row(data, num_samples))
    return np.stack(out)
