"""Run the training pipeline end to end from a dataset directory: speech +
RIR VQ-VAEs -> echoed composite -> encoder fine-tune -> location regressor
(and, with --joint-location, the joint localizer), with stage handoff through
the store, then evaluate the location models on the validation set.

    python -m acoustic_locating_vq_vae_torch.cli.run_pipeline --data-dir DIR [--val-dir DIR] \\
        [--store-dir DIR] [--resume] [--device cpu]

Counterpart of the JAX package's ``scripts/run_pipeline.py`` and of the parts
of ``scripts/_common.py`` that apply here (``base_parser``'s flags,
``exit_on_preemption``). The dataset is a ``SpecsDataset`` directory (the
port's ``data.save_dataset`` or the JAX ``save_dataset`` writes one); it is
not synthesized. SIGTERM during a stage saves a checkpoint and exits with 75
(EX_TEMPFAIL); rerun with ``--resume`` to skip the completed stages and
continue the interrupted one from its checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

__all__ = ["build_parser", "exit_on_preemption", "main"]

EXIT_PREEMPTED = 75  # EX_TEMPFAIL


@contextlib.contextmanager
def exit_on_preemption():
    """Turn a mid-stage :class:`Preempted` (the loop has already saved a
    resumable checkpoint) into exit 75 with a restart hint, not a
    traceback."""
    from ..train import Preempted

    try:
        yield
    except Preempted as e:
        print(f"[preempted] {e}", flush=True)
        sys.exit(EXIT_PREEMPTED)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True, help="SpecsDataset directory of the training set")
    p.add_argument("--val-dir", default=None, help="SpecsDataset directory of the validation set")
    p.add_argument("--store-dir", default="checkpoints", help="stage store / checkpoint root")
    p.add_argument("--updates", type=int, default=None, help="override every stage's number of updates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width-scale", type=float, default=1.0)
    p.add_argument(
        "--preset", choices=["compat", "fixed"], default="fixed",
        help="fixed (default) = the JAX package's best validated configuration (anchored "
        "fine-tune commitment_weight=0.25, quantized-latent location input, vectors VQ "
        "flatten); compat = the exact reference configuration. The library-level "
        "run_pipeline() keeps compat as its default",
    )
    p.add_argument("--vq-ema", action="store_true",
                   help="EMA codebook learning for the VQ stages (default: gradient codebook)")
    p.add_argument("--commitment-weight", type=float, default=None,
                   help="override the preset's fine-tune VQ anchor weight")
    p.add_argument("--location-input-mode", choices=["encodings", "quantized"], default=None,
                   help="location MLP input: one-hot encodings (reference) or dense quantized latents")
    p.add_argument("--location-target-mode", choices=["normalized_angle", "sincos"], default=None,
                   help="location target: theta/pi MSE (reference) or circular (sin, cos); default "
                   "normalized_angle for the frozen location stage, sincos for the joint stage")
    p.add_argument("--vq-flatten", choices=["compat", "vectors"], default=None,
                   help="compat = the reference's memory-order view(-1, D) VQ flatten; vectors = "
                   "channels-last D-vectors (default: the preset's)")
    p.add_argument("--joint-location", action="store_true",
                   help="append the joint stage: the RIR encoder fine-tuned jointly with a fresh "
                   "location head on the angle loss, seeded from the fine-tuned composite")
    p.add_argument("--predict-radius", action="store_true",
                   help="(--joint-location) append a range output to the joint head")
    p.add_argument("--tail-weight", type=float, default=0.0,
                   help="(--joint-location) add this x the mean of the worst ceil(tail-frac x batch) "
                   "per-sample angle errors to the joint loss")
    p.add_argument("--tail-frac", type=float, default=0.125,
                   help="(--tail-weight) worst fraction of the batch to weight")
    p.add_argument("--resume", action="store_true",
                   help="crash-safe restart from the store: skip the stages whose final checkpoint "
                   "exists and continue the first incomplete one from its newest periodic checkpoint")
    p.add_argument("--ckpt-every", type=int, default=None,
                   help="periodic checkpoint cadence in updates (default: the tasks', 1000)")
    p.add_argument("--keep-checkpoints", type=int, default=0, metavar="N",
                   help="keep only the newest N periodic checkpoints of each stage (finals are "
                   "always kept; any N >= 1 stays resumable); 0 keeps everything")
    p.add_argument("--cache-frozen", action="store_true",
                   help="train the echoed and location stages from their frozen branches' codes, "
                   "computed once per dataset")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of a few steady-state steps of each stage here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..data import SpecsDataset
    from ..eval import evaluate_joint_location, evaluate_location
    from ..train import JointLocationTask, LocationTask, run_pipeline

    ds = SpecsDataset(args.data_dir)
    config = ds.config
    train = ds.load_all()
    val = SpecsDataset(args.val_dir).load_all() if args.val_dir else None
    stages = ("speech", "rir", "echoed", "finetune", "location") + (
        ("location_joint",) if args.joint_location else ()
    )
    flatten = None if args.vq_flatten is None else args.vq_flatten == "compat"
    res = run_pipeline(
        args.seed, train, val, store_dir=args.store_dir, config=config, width_scale=args.width_scale,
        updates={k: args.updates for k in stages} if args.updates else None,
        preset=args.preset, vq_ema=args.vq_ema, commitment_weight=args.commitment_weight,
        location_input_mode=args.location_input_mode, location_target_mode=args.location_target_mode,
        compat_vq_flatten=flatten, joint_location=args.joint_location, predict_radius=args.predict_radius,
        joint_task_kwargs=(
            {"tail_weight": args.tail_weight, "tail_frac": args.tail_frac} if args.tail_weight else None
        ),
        resume=args.resume, ckpt_every=args.ckpt_every, device=args.device, log_every=args.log_every,
        profile_dir=args.profile_dir, cache_frozen=args.cache_frozen, keep_checkpoints=args.keep_checkpoints,
    )

    fixed = args.preset == "fixed"
    flatten = flatten if flatten is not None else not fixed
    data = val if val is not None else train
    task = LocationTask(
        config=config, width_scale=args.width_scale,
        input_mode=args.location_input_mode or ("quantized" if fixed else "encodings"),
        target_mode=args.location_target_mode or "normalized_angle", compat_vq_flatten=flatten,
    )
    metrics = evaluate_location(task, res["location"][0], res["finetune"][0], data, device=args.device)
    print("final location evaluation:", json.dumps(metrics, indent=2), flush=True)
    if metrics.get("median_abs_radians", 0.0) > 0.5:
        print(
            "note: a median of ~1.5 rad is the expected stall of the reference's "
            "frozen-composite design (the frozen RIR latents carry too little angle "
            "information and the MLP regresses to the mean; reference "
            "train_location.py:98-102 prints the same plateau as raw MSE). The "
            "localizer this package ships is the joint stage (--joint-location).",
            flush=True,
        )
    if args.joint_location:
        joint_task = JointLocationTask(
            config=config, width_scale=args.width_scale, compat_vq_flatten=flatten,
            target_mode=args.location_target_mode or "sincos", predict_radius=args.predict_radius,
        )
        jm = evaluate_joint_location(joint_task, res["location_joint"][0], data, device=args.device)
        print("joint location evaluation:", json.dumps(jm, indent=2), flush=True)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
