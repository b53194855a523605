"""Evaluate a trained localizer across a grid of reverberation times (and,
optionally, source radii and sensor-noise SNRs).

    python -m acoustic_locating_vq_vae_torch.cli.eval_t60_sweep --store-dir S \\
        [--t60-grid 0.2 0.3 0.4 0.5 0.6] [--radius-grid R ...] [--snr-grid DB ...] [--n 200] [--device cpu]

Counterpart of the JAX package's ``scripts/eval_t60_sweep.py``, with its
JSON keys: for each condition a fresh held-out set is synthesized at exactly
that T60 (full image-source synthesis, not a training RIR bank, so off-grid
generalization is exercised), radius and SNR, from ``--seed + 1000 +
condition index``, and the joint (or frozen) localizer's angle and
coordinate errors are reported (``eval.evaluate_joint_location`` /
``evaluate_location``).
"""

from __future__ import annotations

import dataclasses
import json

import torch

from .common import base_parser, load_datasets, load_localizer_stages

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--t60-grid", type=float, nargs="+", default=[0.2, 0.3, 0.4, 0.5, 0.6],
                   help="reverberation times to evaluate at (exact synthesis per value)")
    p.add_argument("--n", type=int, default=200, help="held-out samples per condition (4 with --smoke)")
    p.add_argument("--radius-grid", type=float, nargs="+", default=None,
                   help="source radii to cross with the T60 grid (default: the config's fixed R)")
    p.add_argument("--snr-grid", type=float, nargs="+", default=None,
                   help="sensor-noise SNRs in dB to cross with the T60 grid (default: noiseless)")
    p.add_argument("--model", choices=["auto", "joint", "frozen"], default="auto",
                   help="joint stage, frozen location head, or auto")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.snr_range:
        print("note: --snr-range is a TRAINING-data flag and is ignored by the per-condition sweep synthesis — "
              "use --snr-grid to evaluate at exact noise levels", flush=True)
    args.dataset_size, args.val_size = 1, 0  # the conditions are synthesized below
    config, _, _ = load_datasets(args)

    from ..data import make_dataset, max_source_radius
    from ..eval import evaluate_joint_location, evaluate_location
    from ..utils import StageStore, resolve_device

    task, params, composite_params, use_joint = load_localizer_stages(args, config, StageStore(args.store_dir))
    device = resolve_device(args.device)
    n = 4 if args.smoke else args.n
    radius_grid = args.radius_grid or [config.R]
    max_r = max_source_radius(config)
    bad = [r for r in radius_grid if not 0.0 < r < max_r]
    if bad:
        raise SystemExit(
            f"--radius-grid values {bad} leave the room (max in-room source radius {max_r:.3f} m around receiver "
            f"{config.receiver_position[:2]}): source_coordinates clips only at the upper walls, so the sweep "
            "would silently evaluate wrong geometry"
        )
    snr_grid = args.snr_grid or [None]
    conditions = [(t, r, s) for t in args.t60_grid for r in radius_grid for s in snr_grid]
    results = {}
    for i, (t60, radius, snr) in enumerate(conditions):
        cfg = dataclasses.replace(config, reverberation_time=float(t60), R=float(radius))
        cond_task = dataclasses.replace(task, config=cfg)
        generator = torch.Generator(device=device).manual_seed(args.seed + 1000 + i)
        batch = make_dataset(generator, n, cfg, batch=min(n, 50), speech_pool=args.speech_pool, device=device,
                             **({} if snr is None else {"snr_range": (float(snr), float(snr))}))
        if use_joint:
            m = evaluate_joint_location(cond_task, params, batch, device=device)
        else:
            m = evaluate_location(cond_task, params, composite_params, batch, device=device)
        # bare "0.4" keys when only the T60 axis is swept; "t60=..." keys as soon as another axis joins
        extra_axes = args.radius_grid is not None or snr is not None
        label = f"t60={t60:g}" if extra_axes else f"{t60:g}"
        if args.radius_grid is not None:
            label += f",R={radius:g}"
        if snr is not None:
            label += f",snr={snr:g}dB"
        results[label] = m
        print(f"{label if extra_axes else f'T60={label}'}: {json.dumps(m)}", flush=True)

    rmses = [m["rmse_radians"] for m in results.values()]
    out = {
        "model": "joint" if use_joint else "frozen",
        "t60_grid": [float(t) for t in args.t60_grid],
        "radius_grid": [float(r) for r in radius_grid],
        "snr_grid_db": None if args.snr_grid is None else [float(s) for s in snr_grid],
        "rmse_radians_min": min(rmses),
        "rmse_radians_max": max(rmses),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
