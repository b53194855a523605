"""Audio resynthesis check (C24: sout_test.py / sound_from_datapoint.ipynb as
a working CLI): take a dataset sample, write its Griffin-Lim audio and, when
the store has a trained speech VQ-VAE, the model's reconstruction with its
spectral SNR.

    python -m acoustic_locating_vq_vae_torch.cli.resynthesize --store-dir S [--out-prefix P] [--index I] \\
        [--gl-iters 32] [--device cpu]

Counterpart of the JAX package's ``scripts/resynthesize.py``, with its
output lines. Griffin-Lim's initial phase comes from a ``torch.Generator``
seeded by ``--seed``. The speech stage's VQ flatten comes from its
checkpoint's metadata, and an EMA codebook from its state dict.
"""

from __future__ import annotations

import torch

from .common import apply_stage_eval_config, base_parser, load_datasets, task_kwargs

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--out-prefix", default="resynth")
    p.add_argument("--index", type=int, default=0, help="dataset sample index")
    p.add_argument("--gl-iters", type=int, default=32)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    config, train, _ = load_datasets(args)

    from ..dsp import znorm
    from ..eval import audio_from_power_spec, spectral_snr_db, write_wav
    from ..eval.serving import _load
    from ..train import SpeechVQVAETask
    from ..utils import StageStore, full_fp32, resolve_device

    device = resolve_device(args.device)
    spec = torch.as_tensor(train.speech_spec[args.index]).to(device, torch.float32)  # (F, T) power
    # one initial phase for both resyntheses, as the JAX script's one key
    phase = lambda: torch.Generator(device=device).manual_seed(args.seed)
    audio = audio_from_power_spec(spec, phase(), config, n_iter=args.gl_iters)
    write_wav(f"{args.out_prefix}_original.wav", audio, config.fs)
    print(f"wrote {args.out_prefix}_original.wav (Griffin-Lim, {args.gl_iters} iters)")
    out = {"original": f"{args.out_prefix}_original.wav"}

    store = StageStore(args.store_dir)
    if not store.has_stage("speech"):
        print("(no trained 'speech' stage in the store; wrote original only)")
        return out
    params = store.load_stage("speech")["model"]
    kw = apply_stage_eval_config(task_kwargs(args, config), store, "speech", keys=("compat_vq_flatten",))
    task = SpeechVQVAETask(**kw, vq_ema=any(k.endswith("ema_counts") for k in params))
    model = _load(task.build_model, params, device)
    orig = torch.abs(spec[None])
    with torch.inference_mode(), full_fp32():
        _, recon, perp = model(znorm(orig, dim=1), train=False, train_vq=False)
    # undo the z-norm for listening: rescale by the original's statistics
    mean = torch.mean(orig, dim=1, keepdim=True)
    std = torch.std(orig, dim=1, keepdim=True) + 1e-8
    recon_power = torch.clamp(recon.float() * std + mean, min=0.0)[0]
    snr = float(spectral_snr_db(spec, recon_power))
    audio_r = audio_from_power_spec(recon_power, phase(), config, n_iter=args.gl_iters)
    write_wav(f"{args.out_prefix}_recon.wav", audio_r, config.fs)
    print(f"wrote {args.out_prefix}_recon.wav (model recon, perplexity {float(perp):.1f}, "
          f"spectral SNR {snr:.1f} dB)")
    out.update(recon=f"{args.out_prefix}_recon.wav", perplexity=float(perp), spectral_snr_db=snr)
    return out


if __name__ == "__main__":
    main()
