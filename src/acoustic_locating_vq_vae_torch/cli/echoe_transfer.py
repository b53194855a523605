"""t-SNE latent analysis: embed the RIR-branch VQ encodings of a trained
composite in 2-D and check that they organize by source angle.

    python -m acoustic_locating_vq_vae_torch.cli.echoe_transfer --store-dir S [--stage finetune|echoed] \\
        [--out tsne_rir.npz] [--probe] [--data-dir D] [--device cpu]

Counterpart of the JAX package's ``scripts/echoe_transfer.py`` (the
reference's scripts/echoe_transfer.py, C23, whose name it keeps): writes the
embedding and the angles to an ``.npz`` (and a PNG where matplotlib is
installed) instead of blocking on ``plt.show()``. The t-SNE needs
scikit-learn and raises an ImportError that names it where it is missing.
``--probe`` also runs the ridge linear probe (``eval.linear_angle_probe``)
on the RIR branch's quantized latents: how much angle is linearly decodable.
The input is the validation set (else the training set) of ``--val-dir`` /
``--data-dir`` or of sets synthesized from ``--seed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import apply_stage_eval_config, base_parser, load_datasets, task_kwargs

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--out", default="tsne_rir.npz")
    p.add_argument("--stage", default=None, help="composite stage (default finetune|echoed)")
    p.add_argument(
        "--probe", action="store_true",
        help="also run the ridge linear probe (eval.linear_angle_probe) on the RIR-branch quantized latents: how "
        "much angle is LINEARLY decodable (the JAX package's VALIDATION.md round-2 latent-study statistic)",
    )
    return p


def probe_features(task, composite_params, data, device, chunk: int = 64) -> np.ndarray:
    """The RIR branch's quantized latents ``(n, F, D)`` of every row of
    ``data``, in chunks of ``chunk`` rows (the JAX script's loop)."""
    from ..utils import full_fp32

    qtask = dataclasses.replace(task, input_mode="quantized")
    rir = qtask.build_frozen(composite_params, device)
    n = int(data.speech_spec.shape[0])
    chunks = []
    with torch.no_grad(), full_fp32():
        for i in range(0, n, chunk):
            spec = torch.as_tensor(data.echoed_spec[i:i + chunk]).to(device, torch.float32)
            chunks.append(qtask.encodings_from_composite(rir, spec).cpu().numpy())
    return np.concatenate(chunks, axis=0)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    config, train, val = load_datasets(args)
    data = val if val is not None else train

    from ..eval import linear_angle_probe, tsne_rir_embedding
    from ..train import LocationTask
    from ..utils import StageStore, resolve_device

    device = resolve_device(args.device)
    store = StageStore(args.store_dir)
    stage = args.stage or ("finetune" if store.has_stage("finetune") else "echoed")
    composite_params = store.load_stage(stage)["model"]

    # the VQ flatten the composite was trained with (its metadata) decides its codes; no shape shows it
    kw = task_kwargs(args, config, location=True)
    apply_stage_eval_config(kw, store, stage, keys=("compat_vq_flatten",))
    task = LocationTask(**kw)
    emb, theta = tsne_rir_embedding(task, composite_params, data, device=device)
    np.savez(args.out, embedding=emb, theta=theta)
    print(f"t-SNE of {emb.shape[0]} RIR encodings written to {args.out}")
    out = {"stage": stage, "n": int(emb.shape[0]), "out": args.out}

    if args.probe:
        feats = probe_features(task, composite_params, data, device)
        n = feats.shape[0]
        split = max(1, int(0.8 * n))
        if n - split < 2:
            print(f"(probe skipped: {n} samples leave no test split)")
        else:
            m = linear_angle_probe(feats[:split], theta[:split], feats[split:], theta[split:])
            print(f"linear angle probe ({stage}, {split}/{n - split} train/test): "
                  f"R^2 {m['r2']:.3f}, angle RMSE {m['angle_rmse_radians']:.3f} rad")
            out["probe"] = m

    try:
        import matplotlib
    except ImportError as e:  # matplotlib is optional; an error in the plot itself is not caught
        print(f"(no plot: {e})")
        return out
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=theta, cmap="hsv", s=8)
    fig.colorbar(sc, label="theta [rad]")
    ax.set_title(f"t-SNE of RIR VQ encodings ({stage})")
    png = args.out.rsplit(".", 1)[0] + ".png"
    fig.savefig(png, dpi=120)
    plt.close(fig)
    print(f"plot written to {png}")
    return out


if __name__ == "__main__":
    main()
