"""Localize sources with a trained stage store: echoed spectrogram in, source
angle and 3-D coordinates out.

    python -m acoustic_locating_vq_vae_torch.cli.locate --store-dir S [--n 8] [--model auto|joint|frozen] \\
        [--latency K] [--data-dir D] [--device cpu]

Counterpart of the JAX package's ``scripts/locate.py``, with its JSON keys.
Uses the joint stage (``location_joint``) when the store has one, else the
frozen ``location`` head over the composite. The input is the first ``--n``
rows of ``--val-dir`` / ``--data-dir`` or of sets synthesized from ``--seed``
(the validation set where there is one).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .common import base_parser, build_localizer, latency_bench, load_datasets

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=8, help="number of samples to localize")
    p.add_argument("--model", choices=["auto", "joint", "frozen"], default="auto",
                   help="which localizer: the joint stage, the frozen location head over the composite, or auto "
                   "(joint when present)")
    p.add_argument("--latency", type=int, default=0, metavar="K",
                   help="serving benchmark: time K calls at batch --n, each on distinct inputs and ending in a "
                   "synchronise and a value fetch (cli.common.latency_bench); per-batch latency and samples/s")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    config, train, val = load_datasets(args)

    from ..utils import StageStore

    data = val if val is not None else train
    spec = torch.as_tensor(data.echoed_spec[: args.n])
    theta_true = torch.as_tensor(data.theta[: args.n]).cpu().numpy().reshape(-1)
    r_true = torch.as_tensor(data.radius[: args.n]).cpu().numpy().reshape(-1)

    serve, use_joint = build_localizer(args, config, StageStore(args.store_dir))
    theta_pred, r_pred, coords_pred = (t.cpu().numpy() for t in serve(spec))
    ang_err = np.angle(np.exp(1j * (theta_pred - theta_true)))
    predicts_radius = serve.predicts_radius
    out = {
        "model": "joint" if use_joint else "frozen",
        "samples": [
            {
                "theta_pred_rad": round(float(tp), 4),
                "coordinates_m": [round(float(c), 3) for c in cp],
                "theta_true_rad": round(float(tt), 4),
                "abs_error_rad": round(float(abs(e)), 4),
                **({"radius_pred_m": round(float(rp), 3)} if predicts_radius else {}),
            }
            for tp, cp, tt, e, rp in zip(theta_pred, coords_pred, theta_true, ang_err, r_pred)
        ],
        "rmse_radians": round(float(np.sqrt(np.mean(ang_err**2))), 4),
    }
    if predicts_radius:
        out["rmse_radius_m"] = round(float(np.sqrt(np.mean((r_pred - r_true) ** 2))), 4)
    if args.latency > 0:
        out["latency"] = latency_bench(serve, spec, args.latency, args.n, device=serve.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
