"""Run the training pipeline end to end: speech + RIR VQ-VAEs -> echoed
composite -> encoder fine-tune -> location regressor (and, with
--joint-location, the joint localizer), with stage handoff through the store,
then evaluate the location models on the validation set.

    python -m acoustic_locating_vq_vae_torch.cli.run_pipeline [--data-dir DIR] [--val-dir DIR] \\
        [--dataset-size N] [--val-size N] [--store-dir DIR] [--resume] [--device cpu]

Counterpart of the JAX package's ``scripts/run_pipeline.py`` and of the parts
of ``scripts/_common.py`` that apply here (``base_parser``'s flags, ``setup``'s
data, ``exit_on_preemption``). Without ``--data-dir`` the training set is
synthesized on the device from ``--seed``, and without ``--val-dir`` the
validation set too (``--val-size 0``: none); a dataset directory is a
``SpecsDataset`` directory (``cli.generate_dataset``, ``data.save_dataset``
or the JAX ``save_dataset`` writes one). A rerun with the same seed
synthesizes the same sets, so ``--resume`` continues on the same data.
SIGTERM during a stage saves a checkpoint and exits with 75 (EX_TEMPFAIL);
rerun with ``--resume`` to skip the completed stages and continue the
interrupted one from its checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

__all__ = [
    "add_synthesis_args", "build_parser", "dataset_seeds", "exit_on_preemption", "load_datasets", "main", "smoke_config",
    "synthesis_kwargs",
]

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
    p.add_argument("--data-dir", default=None, help="SpecsDataset dir (.pt/.npz); default: synthesize on device")
    p.add_argument("--val-dir", default=None, help="validation SpecsDataset dir")
    p.add_argument("--dataset-size", type=int, default=1000, help="synthetic dataset size (genereate_dataset.py:62)")
    p.add_argument("--val-size", type=int, default=200)
    p.add_argument("--smoke", action="store_true", help="tiny config for a fast end-to-end check")
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
    add_synthesis_args(p)
    p.add_argument(
        "--dataset-bf16", action="store_true",
        help="store synthesized dataset spectra in bfloat16 (half the memory; decompressed to f32 per sampled "
        "batch) — for 20k-scale sets",
    )
    return p


def add_synthesis_args(p: argparse.ArgumentParser) -> None:
    """The synthesis flags the pipeline shares with ``generate_dataset``
    (the JAX ``scripts/_common.py:base_parser``)."""
    p.add_argument(
        "--wav-dir", default=None,
        help="directory of 16 kHz wavs to use as the speech corpus for on-device synthesis (the LibriSpeech role, "
        "genereate_dataset.py:93); default: synthetic source-filter speech",
    )
    p.add_argument(
        "--rt60-range", type=float, nargs=2, default=None, metavar=("LO", "HI"),
        help="per-sample reverberation-time domain randomization: T60 ~ U(LO, HI) in synthesized data instead of "
        "the config's fixed value (reference pins T60=0.4, genereate_dataset.py:60)",
    )
    p.add_argument(
        "--radius-range", type=float, nargs=2, default=None, metavar=("LO", "HI"),
        help="per-sample source-radius geometry augmentation: R ~ U(LO, HI) meters around the receiver instead "
        "of the config's fixed R=1 (genereate_dataset.py:17); labels stay angular",
    )
    p.add_argument(
        "--snr-range", type=float, nargs=2, default=None, metavar=("LO", "HI"),
        help="per-sample sensor-noise augmentation: white noise added to the echoed waveform at SNR ~ U(LO, HI) "
        "dB in synthesized data (the reference's generator is noiseless, genereate_dataset.py:21-31); composes "
        "with --rt60-range/--radius-range",
    )
    p.add_argument(
        "--snr-clean-prob", type=float, default=0.0, metavar="P",
        help="with --snr-range: leave each sample CLEAN (no sensor noise) with probability P — a mixed "
        "clean/noisy curriculum that anchors the noiseless operating point (training with --snr-range alone "
        "never shows a clean sample and costs clean accuracy, VALIDATION.md run F)",
    )


def smoke_config():
    """The JAX CLIs' ``--smoke`` geometry: 512-tap RIRs, 0.2 s of audio, 33
    bins x 100 frames."""
    from ..data import DatasetConfig

    return DatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)


def synthesis_kwargs(args) -> dict:
    """``synthesize_batch`` options from the synthesis flags."""
    kw = {}
    if args.rt60_range:
        kw["rt60_range"] = tuple(args.rt60_range)
    if args.radius_range:
        kw["radius_range"] = tuple(args.radius_range)
    if args.snr_range:
        kw["snr_range"] = tuple(args.snr_range)
        if args.snr_clean_prob:
            kw["snr_clean_prob"] = float(args.snr_clean_prob)
    elif args.snr_clean_prob:
        raise SystemExit("--snr-clean-prob requires --snr-range")
    return kw


def dataset_seeds(seed: int):
    """The seeds of the synthesized training and validation sets, derived
    from ``seed`` as the JAX CLI splits its key into ``k_train`` and
    ``k_val`` (``scripts/_common.py:288``); streams apart from the stages'
    (``train.stage_seed``)."""
    return tuple(int(child.generate_state(1)[0]) for child in np.random.SeedSequence(seed).spawn(2))


def load_datasets(args):
    """The pipeline's dataset config, training set and validation set (or
    None) from the flags: read from ``--data-dir`` / ``--val-dir``, or
    synthesized on ``--device`` from ``--seed`` (``--dataset-size`` /
    ``--val-size`` rows, the synthesis flags, ``--wav-dir`` as the speech,
    ``--dataset-bf16``), as the JAX ``scripts/_common.py:setup`` does."""
    import torch

    from ..data import DatasetConfig, SpecsDataset, load_wav_dir, make_dataset
    from ..utils import resolve_device

    config = smoke_config() if args.smoke else DatasetConfig()
    if args.smoke:
        args.dataset_size = min(args.dataset_size, 64)
        args.val_size = min(args.val_size, 32)
    if args.data_dir:
        ds = SpecsDataset(args.data_dir)
        config = ds.config  # resolved before a wav pool is checked against it
    synth_train = not args.data_dir
    synth_val = not args.val_dir and args.val_size > 0
    synth_kw = synthesis_kwargs(args)
    pool = None
    if args.wav_dir:
        if synth_train or synth_val:
            pool = load_wav_dir(args.wav_dir, config.audio_samples)
            print(f"speech corpus: {pool.shape[0]} wavs from {args.wav_dir}", flush=True)
        else:
            print("--wav-dir ignored: both --data-dir and --val-dir are set, nothing is synthesized", flush=True)
    if args.dataset_bf16:
        synth_kw["store_dtype"] = torch.bfloat16
    device = resolve_device(args.device)

    def synthesize(seed: int, size: int):
        generator = torch.Generator(device=device).manual_seed(seed)
        return make_dataset(generator, size, config, speech_pool=pool, device=device, **synth_kw)

    seed_train, seed_val = dataset_seeds(args.seed)
    train = ds.load_all() if args.data_dir else synthesize(seed_train, args.dataset_size)
    if args.val_dir:
        val = SpecsDataset(args.val_dir).load_all()
    else:
        val = synthesize(seed_val, args.val_size) if synth_val else None
    return config, train, val


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..eval import evaluate_joint_location, evaluate_location
    from ..train import JointLocationTask, LocationTask, run_pipeline

    if args.smoke and args.updates is None:
        args.updates = 20
    config, train, val = load_datasets(args)
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
