"""Standalone RIR demo (the reference's scratch_scripts/Impulse_Response.py):
generate a room impulse response, convolve a waveform through it, and write
audio, the response and a plot.

    python -m acoustic_locating_vq_vae_torch.cli.impulse_response_demo [--theta 0.7] \\
        [--out-prefix impulse_demo] [--native] [--seed 0] [--device cpu]

Counterpart of the JAX package's ``scripts/impulse_response_demo.py``. The
source sits at ``--theta`` on the dataset's circle around the receiver
(``dsp.source_coordinates``); its RIR comes from ``dsp.generate_rir`` on the
device, or with ``--native`` from the C++ library on the host (``native``,
float64, cast to float32); the speech is ``data.synthetic_speech_batch``
drawn from a ``torch.Generator`` seeded ``--seed``, convolved through the
RIR by ``dsp.fft_convolve(mode="same")``. Writes ``<prefix>_dry.wav``,
``<prefix>_echoed.wav``, ``<prefix>_rir.npy`` and, where matplotlib is
installed, the three-panel ``<prefix>.png``. Runs on the card unless
``--device cpu``.

The RIR agrees with the JAX script's to float32 rounding, but the wav files
cannot equal its files: the speech comes from a torch generator (Philox on
the card, the Mersenne twister on the CPU), which does not reproduce JAX's
threefry stream from the same seed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .run_pipeline import add_device_arg

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-prefix", default="impulse_demo")
    p.add_argument("--native", action="store_true", help="use the C++ ISM library on the host")
    p.add_argument("--theta", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0, help="seed of the speech's generator")
    add_device_arg(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from .. import dsp
    from ..data import DatasetConfig, synthetic_speech_batch
    from ..eval import write_wav
    from ..utils import resolve_device

    device = resolve_device(args.device)
    cfg = DatasetConfig()
    recv = torch.tensor(cfg.receiver_position, dtype=torch.float32, device=device)
    room = torch.tensor(cfg.room_dimensions, dtype=torch.float32, device=device)
    src = dsp.source_coordinates(torch.tensor(args.theta, dtype=torch.float32, device=device), recv, room, cfg.R,
                                 cfg.Z_LOC_SOURCE)
    print(f"theta={args.theta:.3f} -> source {np.round(src.cpu().numpy(), 3).tolist()}")

    if args.native:
        from .. import native

        h = native.generate_rir_native(
            src.cpu(), cfg.receiver_position, cfg.room_dimensions, cfg.n_sample, cfg.fs, rt60=cfg.reverberation_time,
        ).to(device=device, dtype=torch.float32)
    else:
        h = dsp.generate_rir(src, recv, room=tuple(cfg.room_dimensions), nsample=cfg.n_sample, fs=float(cfg.fs),
                             rt60=cfg.reverberation_time)

    wave = synthetic_speech_batch(torch.Generator(device).manual_seed(args.seed), 1, cfg.audio_samples, cfg.fs)[0]
    echoed = dsp.fft_convolve(wave, h, mode="same")

    prefix = args.out_prefix
    out = {"dry": f"{prefix}_dry.wav", "echoed": f"{prefix}_echoed.wav", "rir": f"{prefix}_rir.npy", "png": None}
    write_wav(out["dry"], wave, cfg.fs)
    write_wav(out["echoed"], echoed, cfg.fs)
    np.save(out["rir"], h.cpu().numpy())
    print(f"wrote {out['dry']} / {out['echoed']} / {out['rir']}")

    try:
        import matplotlib
    except ImportError as e:  # matplotlib is optional; an error in the plot itself is not caught
        print(f"(no plot: {e})")
        return out
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    from ..utils import plot_spectrogram

    fig, axes = plt.subplots(3, 1, figsize=(8, 9))
    axes[0].plot(h.cpu().numpy())
    axes[0].set_title("room impulse response")
    plot_spectrogram(dsp.spectrogram(wave, cfg.NFFT, cfg.HOP_LENGTH, power=2.0), title="dry speech", ax=axes[1])
    plot_spectrogram(dsp.spectrogram(echoed, cfg.NFFT, cfg.HOP_LENGTH, power=2.0), title="echoed speech", ax=axes[2])
    fig.tight_layout()
    out["png"] = f"{prefix}.png"
    fig.savefig(out["png"], dpi=110)
    plt.close(fig)
    print(f"wrote {out['png']}")
    return out


if __name__ == "__main__":
    main()
