"""Generate a synthetic wav corpus with a source-filter distribution
DELIBERATELY shifted from the in-step surrogate (data/speech.py
synthetic_speech_batch): wider pitch range (70-320 Hz), up to five formants
to 4.5 kHz, stronger spectral-tilt variation, per-utterance loudness, so
training from ``--wav-dir`` is a real distribution change, not the surrogate
under another name.

Role: stands in for the reference's LibriSpeech corpus
(genereate_dataset.py:93-97) in an offline environment. Run J (VALIDATION.md
round 4) trains its flagship from a 512-utterance pool written with seed
2024, and run K's recipe reads the same pool; held-out evaluation pools use
a different ``--seed``.

The port's copy of the JAX package's ``scripts/make_shifted_corpus.py``. It
is numpy and scipy on the host, not torch, on purpose: it draws every value
from numpy's ``default_rng(seed)`` in the same order as that script, so
``--seed 2024 --n 512`` writes bitwise the files of run J's and run K's
corpus. A torch generator cannot reproduce that stream, and a corpus is
written once, so the card would gain nothing.

Usage:
    python -m acoustic_locating_vq_vae_torch.cli.make_shifted_corpus --out corpora/corpusJ --n 512 --seed 2024
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile

__all__ = ["main", "synth_utterance"]


def synth_utterance(rng: np.random.Generator, n: int, fs: int) -> np.ndarray:
    """One source-filter utterance: vibrato'd harmonic source + noise mix,
    random formant bank, spectral tilt, slow energy/voicing contours."""
    t = np.arange(n) / fs
    freqs = np.fft.rfftfreq(n, 1.0 / fs)

    f0b = rng.uniform(70.0, 320.0)
    wr = rng.uniform(0.3, 5.0)
    wp = rng.uniform(0, 2 * np.pi)
    depth = rng.uniform(0.02, 0.15)
    f0 = f0b * (1.0 + depth * np.sin(2 * np.pi * wr * t + wp))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    n_harm = rng.integers(8, 20)
    voiced = sum(np.sin(h * phase) / h for h in range(1, n_harm + 1))
    noise = rng.standard_normal(n) * rng.uniform(0.3, 0.8)

    n_ctrl = int(n / fs * rng.uniform(5, 12))
    xp = np.linspace(0, n - 1, n_ctrl)
    energy = np.interp(np.arange(n), xp, rng.uniform(0.02, 1.0, n_ctrl)) ** 2
    voicing = np.interp(np.arange(n), xp, rng.uniform(0.0, 1.0, n_ctrl))
    exc = energy * (voicing * voiced + (1 - voicing) * noise)

    nf = rng.integers(3, 6)
    centers = rng.uniform(250.0, 4500.0, (nf, 1))
    bws = rng.uniform(60.0, 400.0, (nf, 1))
    resp = (1.0 / (1.0 + ((freqs[None, :] - centers) / bws) ** 2)).sum(0)
    tilt_f = rng.uniform(1200.0, 3500.0)
    tilt = 1.0 / (1.0 + (freqs / tilt_f) ** 2)
    spec = np.fft.rfft(exc) * (0.15 + resp) * tilt
    wave = np.fft.irfft(spec, n=n)
    return wave / (np.abs(wave).max() + 1e-8) * rng.uniform(0.5, 1.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output wav directory")
    ap.add_argument("--n", type=int, default=512, help="utterance count")
    ap.add_argument("--seed", type=int, default=2024,
                    help="rng seed (run J train pool: 2024; use another for held-out eval)")
    ap.add_argument("--fs", type=int, default=16000)
    ap.add_argument("--samples", type=int, default=80000,
                    help="samples per utterance (DatasetConfig.audio_samples)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.n):
        wave = synth_utterance(rng, args.samples, args.fs)
        wavfile.write(
            os.path.join(args.out, f"utt{i:04d}.wav"),
            args.fs,
            (wave * 32767).astype(np.int16),
        )
    print(f"wrote {args.n} wavs to {args.out}")


if __name__ == "__main__":
    main()
