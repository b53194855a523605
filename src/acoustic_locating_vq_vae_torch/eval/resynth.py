"""Audio resynthesis checks (C24: sout_test.py, sound_from_datapoint.ipynb):
spectrogram -> waveform by Griffin-Lim or the inverse STFT, a
reconstruction-quality metric and a wav writer.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/resynth.py:19-57``, on
the port's ``dsp/stft.py``. Griffin-Lim's random initial phase comes from
the caller's ``torch.Generator`` (JAX: a PRNG key), so the two packages draw
different phases from the same seed; from the same phase
(``dsp.griffin_lim_from_angle``) they agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.config import DatasetConfig
from ..dsp.stft import griffin_lim, inverse_spectrogram

__all__ = ["audio_from_power_spec", "audio_from_complex_spec", "spectral_snr_db", "write_wav"]


def audio_from_power_spec(
    power_spec: torch.Tensor,
    generator: torch.Generator,
    config: DatasetConfig = DatasetConfig(),
    n_iter: int = 32,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Griffin-Lim phase recovery from a power spectrogram (sout_test.py:25-30),
    its initial phase drawn from ``generator``."""
    return griffin_lim(
        power_spec, generator, n_fft=config.NFFT, hop_length=config.HOP_LENGTH,
        n_iter=n_iter, power=2.0, normalized=True, length=length,
    )


def audio_from_complex_spec(
    spec: torch.Tensor, config: DatasetConfig = DatasetConfig(), length: Optional[int] = None
) -> torch.Tensor:
    """Exact inversion of a complex STFT (sound_from_datapoint.ipynb cell 6)."""
    return inverse_spectrogram(spec, n_fft=config.NFFT, hop_length=config.HOP_LENGTH, normalized=True, length=length)


def spectral_snr_db(reference_power: torch.Tensor, estimate_power: torch.Tensor) -> torch.Tensor:
    """SNR between two power spectrograms in dB (resynthesis quality check)."""
    num = torch.sum(reference_power**2)
    den = torch.sum((reference_power - estimate_power) ** 2) + 1e-12
    return 10.0 * torch.log10(num / den)


def write_wav(path: str, audio, fs: int = 16000) -> None:
    """Write 16-bit PCM, peak-normalized to 0.95 (handle_rir_dataset_example.ipynb
    cell 5 equivalent)."""
    from scipy.io import wavfile

    audio = audio.detach().cpu().numpy() if isinstance(audio, torch.Tensor) else np.asarray(audio)
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak * 0.95
    wavfile.write(path, fs, (audio * 32767).astype(np.int16))
