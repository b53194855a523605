"""Export a trained localizer from a stage store as one self-contained
artifact (``torch.export``): echoed power spectrogram (or, with
--from-audio, raw waveform) in, (angle, radius, 3-D coordinates) out,
weights embedded, symbolic batch dimension; then reload it cold and check it
against the live model.

    python -m acoustic_locating_vq_vae_torch.cli.export_localizer --store-dir S --out-dir A \\
        [--model auto|joint|frozen] [--export-batch B] [--from-audio] [--verify-n N] [--latency K] [--device cpu]

Counterpart of the JAX package's ``scripts/export_localizer.py``.
``--device`` takes the place of ``--export-platforms``: the artifact's
weights live on the device it was exported on (``serving.json``'s
``platforms``), and the graph calls the VQ assignment as the registered
operator, so on the card the artifact runs the ``vq_nearest`` kernel. Loading
it needs ``torch`` and the port's ``ops.vq`` module (which registers the
operator), not the model classes (``eval.load_localizer``). The
reload-and-compare summary goes into the sidecar (``eval_summary``); the
command exits non-zero if the artifact differs from the live model by 1e-4
or more.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .common import base_parser, latency_bench, load_datasets, load_localizer_stages, rir_branch

__all__ = ["build_parser", "main"]

VERIFY_ATOL = 1e-4  # the JAX script's gate (scripts/export_localizer.py:131-133)


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", required=True, help="artifact output directory")
    p.add_argument("--model", choices=["auto", "joint", "frozen"], default="auto",
                   help="which localizer stage to export (auto = joint when present)")
    p.add_argument("--export-batch", type=int, default=None,
                   help="pin the exported batch size (default: symbolic, one artifact serves any batch size)")
    p.add_argument("--verify-n", type=int, default=8, help="synthesized samples for the reload-and-compare check")
    p.add_argument("--from-audio", action="store_true",
                   help="fuse the STFT frontend into the artifact: the input becomes the raw echoed waveform "
                   "(B, config.audio_samples) instead of a power spectrogram")
    p.add_argument("--latency", type=int, default=0, metavar="K",
                   help="serving benchmark on the reloaded artifact: time K calls at batch --verify-n "
                   "(cli.common.latency_bench, as cli.locate uses)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.val_size = 0
    args.dataset_size = max(2, args.verify_n)
    config, train, _ = load_datasets(args)

    from ..eval import export_localizer, load_localizer, make_serving_fn
    from ..eval.serving import params_fingerprint, store_provenance, update_sidecar
    from ..utils import StageStore

    store = StageStore(args.store_dir)
    task, params, composite_params, use_joint = load_localizer_stages(args, config, store)
    # one closure, exported and compared against
    branch = None if use_joint else rir_branch(composite_params)
    serve = make_serving_fn(task, params, config, branch, device=args.device, from_audio=args.from_audio)
    prov = store_provenance(store, "location_joint" if use_joint else "location", params, task=task)
    if not use_joint:
        prov["composite_stage"] = "finetune" if store.has_stage("finetune") else "echoed"
        prov["composite_params_sha256"] = params_fingerprint(composite_params)
    t0 = time.perf_counter()
    meta = export_localizer(task, params, config, args.out_dir, batch_size=args.export_batch, serve_fn=serve,
                            provenance=prov)
    print(f"exported {meta['model']} localizer -> {args.out_dir} ({meta['bytes']} bytes, platforms "
          f"{meta['platforms']}) in {time.perf_counter() - t0:.3f} s", flush=True)

    # reload the artifact cold and compare with the live model
    call, meta2 = load_localizer(args.out_dir)
    if args.from_audio:
        # the dataset holds spectrograms, not waveforms: program equality (artifact against the live
        # closure, one STFT frontend) is checked on seeded surrogate waveforms of the declared shape
        x = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
            (args.verify_n, config.audio_samples)).astype(np.float32))
    else:
        x = torch.as_tensor(train.echoed_spec[: args.verify_n])
    live = [t.cpu().numpy() for t in serve(x)]
    art = [t.cpu().numpy() for t in call(x)]
    diffs = [float(np.max(np.abs(a - b))) for a, b in zip(live, art)]
    ok = all(d < VERIFY_ATOL for d in diffs)
    out = {
        "verified": ok,
        "max_abs_diff": dict(zip(meta2["outputs"], diffs)),
        "theta_pred_rad": [round(float(t), 4) for t in art[0]],
    }
    if args.latency > 0:
        out["artifact_latency"] = latency_bench(call, x, args.latency, int(x.shape[0]), device=serve.device)
    update_sidecar(args.out_dir, eval_summary=out)
    print(json.dumps(out))
    if not ok:
        raise SystemExit("artifact output diverges from the live model")
    return out


if __name__ == "__main__":
    main()
