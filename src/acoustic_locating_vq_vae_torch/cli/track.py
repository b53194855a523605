"""Track a moving source with the trained localizer.

    python -m acoustic_locating_vq_vae_torch.cli.track --store-dir S --trajectory arc \\
        --theta-start -2.8 --theta-end 2.8 --windows 48 [--out track.npz] [--device cpu]
    python -m acoustic_locating_vq_vae_torch.cli.track --store-dir S --trajectory walk \\
        --radius-start 0.7 --radius-end 1.3

Counterpart of the JAX package's ``scripts/track.py``, with its JSON keys: a
piecewise-static trajectory (the source holds each position for one
utterance window, the model's fixed 500-frame input, then moves) is
synthesized at exact geometry (``synthesize_batch(theta=, radius=)``, no RIR
bank snapping), every window is localized in one batch, and the angle track
is smoothed by a constant-velocity alpha-beta filter that follows the source
through the +-pi seam (``eval.tracking``). Every random value (the speech,
and with ``--wav-dir`` the utterance picks) comes from one ``torch.Generator``
seeded by ``--seed``. Reports raw and smoothed tracking RMSE, the per-window
estimates and, with a range head, the radial tracking error.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .common import base_parser, build_localizer, load_datasets

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--windows", type=int, default=24, help="trajectory length (one ~5 s utterance window per position)")
    p.add_argument("--trajectory", choices=["arc", "walk"], default="arc")
    p.add_argument("--theta-start", type=float, default=-2.5, help="arc start angle (rad)")
    p.add_argument("--theta-end", type=float, default=2.5, help="arc end angle (rad; may exceed +-pi to cross the seam)")
    p.add_argument("--radius-start", type=float, default=None,
                   help="source radius at the first window (m; default config.R)")
    p.add_argument("--radius-end", type=float, default=None, help="radius at the last window (default: --radius-start)")
    p.add_argument("--walk-step", type=float, default=0.15, help="random-walk angular step std (rad)")
    p.add_argument("--walk-radius-step", type=float, default=0.0, help="random-walk radial step std (m)")
    p.add_argument("--alpha", type=float, default=0.5, help="alpha-beta filter position gain")
    p.add_argument("--beta", type=float, default=0.1, help="alpha-beta filter rate gain")
    p.add_argument("--model", choices=["auto", "joint", "frozen"], default="auto",
                   help="which localizer (see cli.locate)")
    p.add_argument("--out", default=None, help="write the full track (true/pred/smoothed arrays) to this .npz")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # the config, the speech pool and the synthesis options; the trajectory is synthesized below
    args.dataset_size, args.val_size = 1, 0
    config, _, _ = load_datasets(args)

    from ..data import max_source_radius, synthesize_batch
    from ..eval import alpha_beta_filter, arc_trajectory, track_metrics, walk_trajectory, wrap_angle
    from ..utils import StageStore, resolve_device

    r0 = config.R if args.radius_start is None else args.radius_start
    if args.trajectory == "arc":
        theta_traj, radius_traj = arc_trajectory(args.windows, args.theta_start, args.theta_end, r0, args.radius_end)
    else:
        theta_traj, radius_traj = walk_trajectory(args.windows, seed=args.seed, theta_step=args.walk_step, radius=r0,
                                                  radius_step=args.walk_radius_step)
    # synthesize_batch validates only radius_range draws; given radii are checked here
    max_r = max_source_radius(config)
    if radius_traj.max() >= max_r or radius_traj.min() <= 0:
        raise SystemExit(
            f"trajectory radius range [{radius_traj.min():.3f}, {radius_traj.max():.3f}] leaves the room (max "
            f"in-room source radius {max_r:.3f} m around receiver {config.receiver_position[:2]})"
        )

    device = resolve_device(args.device)
    synth_kw = dict(args.synth_kwargs)
    for k in ("rir_bank", "rir_bank_radii", "radius_range"):  # exact geometry: no grid snapping, given radii
        synth_kw.pop(k, None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.speech_pool is not None:
        pool = torch.as_tensor(np.asarray(args.speech_pool, np.float32), device=device)
        idx = torch.randint(pool.shape[0], (args.windows,), generator=generator, device=device)
        synth_kw["speech"] = pool[idx]
    batch = synthesize_batch(
        generator, args.windows, config, theta=torch.from_numpy(wrap_angle(theta_traj)).to(device),
        radius=torch.from_numpy(radius_traj).to(device), device=device, **synth_kw,
    )

    serve, use_joint = build_localizer(args, config, StageStore(args.store_dir))
    theta_pred, radius_pred, _ = (t.cpu().numpy() for t in serve(batch.echoed_spec))
    theta_smoothed = alpha_beta_filter(theta_pred, args.alpha, args.beta)
    r_pred = radius_pred if serve.predicts_radius else None
    theta_true = wrap_angle(theta_traj)
    metrics = track_metrics(theta_true, theta_pred, theta_smoothed, radius_true=radius_traj, radius_pred=r_pred)
    out = {
        "model": "joint" if use_joint else "frozen",
        "trajectory": args.trajectory,
        "windows": int(args.windows),
        "window_seconds": round(config.audio_samples / config.fs, 3),
        **{k: round(v, 4) for k, v in metrics.items()},
        "track": [
            {
                "theta_true_rad": round(float(t), 4),
                "theta_pred_rad": round(float(pr), 4),
                "theta_smoothed_rad": round(float(sm), 4),
                **({"radius_true_m": round(float(rt), 3), "radius_pred_m": round(float(rp), 3)}
                   if r_pred is not None else {}),
            }
            for t, pr, sm, rt, rp in zip(theta_true, theta_pred, theta_smoothed, radius_traj,
                                         r_pred if r_pred is not None else radius_traj)
        ],
    }
    if args.out:
        np.savez(args.out, theta_true=theta_true, theta_pred=theta_pred, theta_smoothed=theta_smoothed,
                 radius_true=radius_traj, **({"radius_pred": r_pred} if r_pred is not None else {}))
        out["saved"] = args.out
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
