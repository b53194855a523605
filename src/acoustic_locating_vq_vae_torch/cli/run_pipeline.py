"""Run the training pipeline end to end: speech + RIR VQ-VAEs -> echoed
composite -> encoder fine-tune -> location regressor (and, with
--joint-location, the joint localizer), with stage handoff through the store,
then evaluate the location models on the validation set.

    python -m acoustic_locating_vq_vae_torch.cli.run_pipeline [--data-dir DIR] [--val-dir DIR] \\
        [--dataset-size N] [--val-size N] [--store-dir DIR] [--resume] [--device cpu]

Counterpart of the JAX package's ``scripts/run_pipeline.py`` and of the parts
of ``scripts/_common.py`` that apply here (``base_parser``'s flags, ``setup``'s
data and RIR bank, ``trainer_kwargs``, ``recipe_kwargs``,
``exit_on_preemption``). Without ``--data-dir`` the training set is
synthesized on the device from ``--seed``, and without ``--val-dir`` the
validation set too (``--val-size 0``: none); a dataset directory is a
``SpecsDataset`` directory (``cli.generate_dataset``, ``data.save_dataset``
or the JAX ``save_dataset`` writes one). A rerun with the same seed
synthesizes the same sets, so ``--resume`` continues on the same data.
SIGTERM during a stage saves a checkpoint and exits with 75 (EX_TEMPFAIL);
rerun with ``--resume`` to skip the completed stages and continue the
interrupted one from its checkpoint.

``--on-the-fly`` synthesizes every training batch inside the step, with the
synthesis flags (no training set is made or read; the validation set still
is), and ``--rir-bank N`` builds a bank of N angles on the device (times
``--rir-bank-rt60s`` T60s over ``--rt60-range`` and ``--rir-bank-radii``
radii over ``--radius-range``, which the bank's axes then replace) that the
synthesized sets and batches draw from, as the JAX CLI does: every
on-the-fly stage then draws from it. ``--joint-location
--bank-pretrain-updates N`` trains the joint stage N updates from the bank
and polishes the rest with exact synthesis over the ranges
(``--polish-bank-prob P``: a mixed polish). Run K's recipe
(scripts/run_runK.sh), stages 1-5 exact and the joint stage bank then
exact, is two commands on one store: the first without ``--rir-bank`` and
``--joint-location``, the second the same with ``--resume
--joint-location --predict-radius --tail-weight 1.0 --rir-bank 1024
--rir-bank-rt60s 8 --rir-bank-radii 8 --bank-pretrain-updates 350000
--updates 400000``; one command with all of it trains stages 1-5 from the
bank too.

``--librispeech-dir ROOT`` (``--librispeech-url`` split, default
train-clean-100) takes the speech of every synthesized set from a LibriSpeech
checkout, as ``--wav-dir`` does from a directory of wavs; the two exclude each
other. ``--host-staged CHUNK_SIZE`` synthesizes the training set into pinned
host memory and trains every stage from CHUNK_SIZE-row chunks on the card,
rotated every ``--rotate-every`` steps (``Trainer.fit``); the stages share
the one set, so ``--prune-dataset`` is ignored here and applies in the
per-stage CLIs (``cli.train_speech`` ...).

Data parallelism over N cards of one machine (the JAX ``--mesh-data``)::

    torchrun --nproc-per-node N -m acoustic_locating_vq_vae_torch.cli.run_pipeline --data-parallel ...

Every rank makes (or reads) the same sets from ``--seed`` and trains its
share of each batch on ``cuda:{LOCAL_RANK}`` over NCCL; the mesh's first rank
alone writes the store, prints and evaluates. The other axes of the JAX mesh
lay the same ranks out as ``(data, model, seq)`` (``parallel.make_mesh``)::

    torchrun --nproc-per-node 2 -m acoustic_locating_vq_vae_torch.cli.run_pipeline --mesh-seq 2 --sequence-parallel ...
    torchrun --nproc-per-node 2 -m acoustic_locating_vq_vae_torch.cli.run_pipeline --mesh-model 2 --model-parallel ...

``--sequence-parallel`` shards the time axis of the speech, echoed and
finetune stages over the ``seq`` axis (it needs the vectors VQ flatten, the
``fixed`` preset's; the compat flatten raises), ``--model-parallel`` splits
the large parameters over the ``model`` axis, and ``--mesh-slices N`` orders
the ranks node by node (torchrun's ``GROUP_RANK``) so that only the data axis
crosses nodes. ``--device cpu`` runs every axis over gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

__all__ = [
    "add_data_args", "add_device_arg", "add_mesh_args", "add_model_args", "add_synthesis_args", "add_training_args",
    "build_parser", "data_parallel", "dataset_seeds", "evaluation_set", "exit_on_preemption", "load_datasets",
    "load_speech_pool", "main", "otf_kwargs", "recipe_kwargs", "smoke_config", "synthesis_kwargs",
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
    add_data_args(p)
    add_model_args(p)
    add_training_args(p)
    p.add_argument(
        "--preset", choices=["compat", "fixed"], default="fixed",
        help="fixed (default) = the JAX package's best validated configuration (anchored "
        "fine-tune commitment_weight=0.25, quantized-latent location input, vectors VQ "
        "flatten); compat = the exact reference configuration. The library-level "
        "run_pipeline() keeps compat as its default",
    )
    p.add_argument("--commitment-weight", type=float, default=None,
                   help="override the preset's fine-tune VQ anchor weight")
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
    add_synthesis_args(p)
    add_mesh_args(p)
    return p


def add_training_args(p: argparse.ArgumentParser) -> None:
    """The training flags the pipeline shares with the per-stage CLIs (the
    JAX ``scripts/_common.py:base_parser``)."""
    p.add_argument("--updates", type=int, default=None, help="override every stage's number of updates")
    p.add_argument("--vq-ema", action="store_true",
                   help="EMA codebook learning for the VQ stages (default: gradient codebook)")
    p.add_argument("--resume", action="store_true",
                   help="crash-safe restart from the store: a stage restarts from its newest periodic checkpoint; "
                   "run_pipeline also skips the stages whose final checkpoint exists")
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
    p.add_argument(
        "--on-the-fly", action="store_true",
        help="synthesize a fresh training batch inside every step (infinite data; no training dataset needed)",
    )
    p.add_argument(
        "--rir-bank", type=int, default=0, metavar="N_THETA",
        help="precompute an N_THETA-angle RIR bank once and draw per-sample RIRs from it (grid labels; spacing "
        "2pi/N) instead of running image-source synthesis per sample — makes --on-the-fly steps nearly RIR-free. "
        "Combined with --rt60-range the bank gets a T60 grid axis (--rir-bank-rt60s values spanning the range)",
    )
    p.add_argument("--rir-bank-rt60s", type=int, default=8,
                   help="T60 grid size for a reverberation-randomized RIR bank (used when --rir-bank and "
                   "--rt60-range are both set)")
    p.add_argument(
        "--rir-bank-radii", type=int, default=8,
        help="source-radius grid size for a geometry-randomized RIR bank (used when --rir-bank and --radius-range "
        "are both set; radius labels are then drawn on the grid). Keep the grid spacing within ~5 cm: coarser "
        "grids localize ON the grid but degrade centimeters off it at near range (VALIDATION.md run G); "
        "alternatively finish with an exact-synthesis leg (run H)",
    )
    p.add_argument(
        "--bank-pretrain-updates", type=int, default=0, metavar="N",
        help="(--on-the-fly --rir-bank, the joint location stage) the validated production recipe as ONE command "
        "(VALIDATION.md run H): train the joint stage's first N updates drawing from the RIR bank, then drop the "
        "bank and polish the remaining updates with exact per-sample image-source synthesis (continuous "
        "rt60/radius randomization restored)",
    )
    p.add_argument(
        "--polish-bank-prob", type=float, default=0.0, metavar="P",
        help="(--bank-pretrain-updates) soften the bank->exact leg boundary: each polish-leg sample draws from the "
        "RIR bank with probability P (geometry snapped to the bank grid, labels matching) and pays exact "
        "synthesis otherwise. 0 (default) = the validated hard switch",
    )
    p.add_argument(
        "--dataset-bf16", action="store_true",
        help="store synthesized dataset spectra in bfloat16 (half the memory; decompressed to f32 per sampled "
        "batch) — for 20k-scale sets",
    )
    p.add_argument(
        "--prune-dataset", action="store_true",
        help="keep only the SampleBatch fields THIS stage reads in the synthesized dataset (~3x less memory; "
        "per-stage CLIs only — the pipeline shares one dataset across stages)",
    )
    p.add_argument(
        "--host-staged", type=int, default=0, metavar="CHUNK_SIZE",
        help="generate the dataset into (pinned) HOST memory and train from CHUNK_SIZE-row device-resident "
        "chunks rotated every --rotate-every steps — for datasets beyond the card's memory (reference 20k_set). "
        "Peak device memory is TWO chunks (the next chunk is copied from mid-window on a side stream to overlap "
        "the transfer), so size CHUNK_SIZE accordingly",
    )
    p.add_argument("--rotate-every", type=int, default=500, help="chunk rotation cadence for --host-staged")


def add_data_args(p: argparse.ArgumentParser) -> None:
    """The data, store, seed and device flags every entry point that reads a
    store shares with the pipeline (the JAX ``scripts/_common.py:base_parser``)."""
    p.add_argument("--data-dir", default=None, help="SpecsDataset dir (.pt/.npz); default: synthesize on device")
    p.add_argument("--val-dir", default=None, help="validation SpecsDataset dir")
    p.add_argument("--dataset-size", type=int, default=1000, help="synthetic dataset size (genereate_dataset.py:62)")
    p.add_argument("--val-size", type=int, default=200)
    p.add_argument("--smoke", action="store_true", help="tiny config for a fast end-to-end check")
    p.add_argument("--store-dir", default="checkpoints", help="stage store / checkpoint root")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    """``--device``: the card unless ``--device cpu``."""
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model flags the pipeline shares with the entry points that read
    its store: the width and the task modes (a checkpoint's metadata
    overrides a mode it records, ``cli.common.apply_stage_eval_config``)."""
    p.add_argument("--width-scale", type=float, default=1.0,
                   help="conv and codebook widths relative to the published model (1.0)")
    p.add_argument("--location-input-mode", choices=["encodings", "quantized"], default=None,
                   help="location MLP input: one-hot encodings (reference) or dense quantized latents")
    p.add_argument("--location-target-mode", choices=["normalized_angle", "sincos"], default=None,
                   help="location target: theta/pi MSE (reference) or circular (sin, cos); default "
                   "normalized_angle for the frozen location stage, sincos for the joint stage")
    p.add_argument("--vq-flatten", choices=["compat", "vectors"], default=None,
                   help="compat = the reference's memory-order view(-1, D) VQ flatten; vectors = "
                   "channels-last D-vectors (default: the preset's)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="conv-stack compute dtype of every stage and of the evaluations (parameters, losses, the "
                   "VQ assignment and the location head stay float32)")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The parallelism flags (the JAX ``scripts/_common.py:46-63``)."""
    p.add_argument("--data-parallel", action="store_true",
                   help="train data-parallel over the ranks torchrun started (torchrun --nproc-per-node N): one card "
                   "per rank, NCCL, each rank its block of every batch; rank 0 writes the store")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="data-parallel axis size; -1 (default) = every rank the other axes leave")
    p.add_argument("--mesh-model", type=int, default=1, help="model-parallel axis size (under torchrun)")
    p.add_argument("--mesh-seq", type=int, default=1, help="sequence-parallel axis size: time sharding (under torchrun)")
    p.add_argument("--mesh-slices", type=int, default=1,
                   help="multi-node layouts: order the ranks node by node (torchrun's GROUP_RANK) so that only the "
                   "data axis crosses nodes and every model/seq group stays within one (make_mesh(slices=))")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="shard the time axis over the 'seq' mesh axis (needs the vectors VQ flatten); speech, "
                   "echoed, and finetune stages — the rir stage's conv length is the short freq axis, as is the "
                   "location stages'")
    p.add_argument("--model-parallel", action="store_true", help="shard large params over the model axis")


def data_parallel(args):
    """The rank's :class:`..parallel.DataParallel` handle on the mesh the
    flags ask for, or None: under ``--data-parallel`` or any mesh axis above
    one, the group torchrun set up is joined (on ``cuda:{LOCAL_RANK}``, which
    replaces ``args.device``) and its ranks laid out by ``make_mesh``."""
    from ..parallel import init_data_parallel, make_mesh

    if args.sequence_parallel and args.vq_flatten == "compat":
        raise ValueError("--sequence-parallel requires the vectors VQ flatten (--vq-flatten vectors): the "
                         "reference's memory-order flatten chunks across time positions and cannot be computed "
                         "with the time axis sharded")
    if args.sequence_parallel and args.vq_flatten is None and args.preset == "compat":
        raise ValueError("--sequence-parallel requires the vectors VQ flatten: --preset compat resolves to the "
                         "reference's memory-order flatten; add --vq-flatten vectors")
    axes = max(args.mesh_model, args.mesh_seq, args.mesh_slices) > 1
    if not (args.data_parallel or axes):
        if args.mesh_data not in (-1, 1):
            raise SystemExit(f"--mesh-data {args.mesh_data} needs --data-parallel under torchrun --nproc-per-node N")
        return None
    world = init_data_parallel(device=args.device)
    mesh = make_mesh(data=args.mesh_data, model=args.mesh_model, seq=args.mesh_seq, slices=args.mesh_slices,
                     world=world)
    if mesh is None:
        raise SystemExit(f"the mesh {args.mesh_data} x {args.mesh_model} x {args.mesh_seq} leaves rank "
                         f"{world.global_rank} of {world.world_size} out: start as many ranks as the mesh holds")
    args.device = str(world.device)
    return mesh


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
    p.add_argument(
        "--librispeech-dir", default=None,
        help="root of a LibriSpeech checkout to use as the speech corpus (walks <root>/LibriSpeech/<url>/... "
        "without torchaudio; .wav via scipy, .flac via soundfile where it imports, else the built-in decoder). "
        "Mutually exclusive with --wav-dir",
    )
    p.add_argument("--librispeech-url", default="train-clean-100",
                   help="LibriSpeech split name under --librispeech-dir (reference: train-clean-100, "
                   "genereate_dataset.py:93)")


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


def load_speech_pool(args, config, needed: bool = True):
    """The speech corpus of ``--wav-dir`` or ``--librispeech-dir`` (at
    ``config.audio_samples``), announced, or None; the two flags exclude
    each other. Where nothing is synthesized (not ``needed``) neither is
    read, with JAX's note."""
    from ..data import load_librispeech, load_wav_dir

    wav_dir, libri_dir = args.wav_dir, args.librispeech_dir
    if wav_dir and libri_dir:
        raise SystemExit("--wav-dir and --librispeech-dir are mutually exclusive")
    if (wav_dir or libri_dir) and not needed:
        print("--wav-dir/--librispeech-dir ignored: both --data-dir and --val-dir are set, nothing is synthesized",
              flush=True)
        return None
    if wav_dir:
        pool = load_wav_dir(wav_dir, config.audio_samples)
        src = f"wavs from {wav_dir}"
    elif libri_dir:
        pool = load_librispeech(libri_dir, url=args.librispeech_url, num_samples=config.audio_samples)
        src = f"LibriSpeech {args.librispeech_url} utterances from {libri_dir}"
    else:
        return None
    print(f"speech corpus: {pool.shape[0]} {src}", flush=True)
    return pool


def load_datasets(args, resident_fields=None):
    """The dataset config, training set and validation set (or None) from
    the flags, the one setup of the pipeline, every per-stage CLI and the
    deploy CLIs: read from ``--data-dir`` / ``--val-dir``, or synthesized on
    ``--device`` from ``--seed`` (``--dataset-size`` / ``--val-size`` rows,
    the synthesis flags, ``--wav-dir`` or ``--librispeech-dir`` as the
    speech, ``--dataset-bf16``), as the JAX ``scripts/_common.py:setup``
    does; with ``--rir-bank`` the bank is built first and the synthesized
    sets draw from it. ``--host-staged`` makes the training set a
    :class:`..data.HostStagedDataset` (synthesized into pinned host memory,
    or the ``--data-dir`` set moved there). ``resident_fields``, a stage's
    fields, is what ``--prune-dataset`` keeps; without it the entry point is
    not stage-scoped and the flag is ignored. Under ``--on-the-fly`` no
    training set is made or read (None). Keeps the synthesis options, the
    bank and the speech pool on ``args`` for :func:`otf_kwargs` and
    :func:`recipe_kwargs`."""
    import torch

    from ..data import DatasetConfig, HostStagedDataset, SpecsDataset, make_dataset, make_host_dataset, make_rir_bank
    from ..utils import resolve_device

    config = smoke_config() if args.smoke else DatasetConfig()
    if args.smoke:
        args.dataset_size = min(args.dataset_size, 64)
        args.val_size = min(args.val_size, 32)
    if args.data_dir:
        ds = SpecsDataset(args.data_dir)
        config = ds.config  # resolved before a speech pool is checked against it
    synth_train = not args.data_dir and not args.on_the_fly
    synth_val = not args.val_dir and args.val_size > 0
    if args.host_staged and args.on_the_fly:
        raise SystemExit("--host-staged stages a training set, and --on-the-fly makes none")
    synth_kw = synthesis_kwargs(args)
    pool = load_speech_pool(args, config, needed=synth_train or synth_val or args.on_the_fly)
    device = resolve_device(args.device)
    # the continuous ranges before the bank's axes replace them: the exact polish of --bank-pretrain-updates
    exact_kw = dict(synth_kw)
    if args.rir_bank and not (synth_train or synth_val or args.on_the_fly):
        print("--rir-bank ignored: dataset comes from --data-dir/--val-dir and --on-the-fly is off, so nothing "
              "synthesizes from the bank", flush=True)
    elif args.rir_bank:
        rt60s = radii = None
        if args.rt60_range:
            rt60s = np.linspace(args.rt60_range[0], args.rt60_range[1], args.rir_bank_rt60s)
            synth_kw.pop("rt60_range")  # the bank's T60 axis replaces it
        if args.radius_range:
            radii = np.linspace(args.radius_range[0], args.radius_range[1], args.rir_bank_radii)
            synth_kw.pop("radius_range")  # the bank's radius axis replaces it
            synth_kw["rir_bank_radii"] = radii.astype(np.float32)
        print(f"building RIR bank: {args.rir_bank} angles" + (f" x {len(rt60s)} T60s" if rt60s is not None else "")
              + (f" x {len(radii)} radii" if radii is not None else ""), flush=True)
        synth_kw["rir_bank"] = make_rir_bank(config, n_theta=args.rir_bank, rt60s=rt60s, radii=radii, device=device)
    args.synth_kwargs, args.exact_synth_kwargs, args.speech_pool = dict(synth_kw), exact_kw, pool
    if args.dataset_bf16:
        synth_kw["store_dtype"] = torch.bfloat16
    if args.prune_dataset:
        if resident_fields is None:
            print("--prune-dataset ignored: this entry point is not stage-scoped", flush=True)
        else:
            synth_kw["keep_fields"] = tuple(resident_fields)

    def generator(seed: int):
        return torch.Generator(device=device).manual_seed(seed)

    seed_train, seed_val = dataset_seeds(args.seed)
    train = None
    if args.data_dir and not args.on_the_fly:
        train = ds.load_all()
        if args.host_staged:
            train = HostStagedDataset(train, args.host_staged, args.rotate_every, pin_memory=device.type == "cuda")
    elif args.host_staged:
        train = make_host_dataset(generator(seed_train), args.dataset_size, config, chunk_size=args.host_staged,
                                  rotate_every=args.rotate_every, speech_pool=pool, device=device, **synth_kw)
    elif synth_train:
        train = make_dataset(generator(seed_train), args.dataset_size, config, speech_pool=pool, device=device,
                             **synth_kw)
    if args.val_dir:
        val = SpecsDataset(args.val_dir).load_all()
    elif synth_val:
        val = make_dataset(generator(seed_val), args.val_size, config, speech_pool=pool, device=device, **synth_kw)
    else:
        val = None
    return config, train, val


def evaluation_set(train, val):
    """The set the final evaluations read: the validation set, else the
    training set (a host-staged one's host arrays)."""
    from ..data import HostStagedDataset

    if val is not None:
        return val
    return train.arrays if isinstance(train, HostStagedDataset) else train


def otf_kwargs(args) -> dict:
    """The trainer options of ``--on-the-fly`` after :func:`load_datasets`
    (the JAX ``scripts/_common.py:trainer_kwargs``): the synthesis options
    with the bank and the speech pool; without ``--on-the-fly`` nothing."""
    if not args.on_the_fly:
        return {}
    synth_kw = dict(args.synth_kwargs)
    if args.speech_pool is not None:
        synth_kw["speech_pool"] = args.speech_pool
    return {"on_the_fly": True, "synth_kwargs": synth_kw}


def recipe_kwargs(args) -> dict:
    """The joint recipe's options of ``--bank-pretrain-updates`` after
    :func:`load_datasets` (the JAX ``scripts/_common.py:recipe_kwargs``): the
    leg boundary, the polish's exact options (the continuous ranges, the
    speech pool) and the mixed-polish probability; nothing without the flag."""
    if not args.bank_pretrain_updates:
        return {}
    if not (args.on_the_fly and args.rir_bank):
        raise SystemExit("--bank-pretrain-updates requires --on-the-fly --rir-bank N (leg 1 trains from the bank)")
    exact = dict(args.exact_synth_kwargs)
    if args.speech_pool is not None:
        exact["speech_pool"] = args.speech_pool
    return {"joint_bank_updates": int(args.bank_pretrain_updates), "joint_exact_synth_kwargs": exact,
            "joint_polish_bank_prob": float(args.polish_bank_prob)}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.bank_pretrain_updates and not args.joint_location:
        raise SystemExit("--bank-pretrain-updates needs --joint-location")
    dp = data_parallel(args)
    try:
        _train_and_evaluate(args, dp)
    finally:
        if dp is not None:
            import torch.distributed

            torch.distributed.destroy_process_group()


def _train_and_evaluate(args, dp) -> None:
    from ..eval import evaluate_joint_location, evaluate_location
    from ..train import JointLocationTask, LocationTask, run_pipeline

    if args.smoke and args.updates is None:
        args.updates = 20
    config, train, val = load_datasets(args)
    recipe = recipe_kwargs(args)
    stages = ("speech", "rir", "echoed", "finetune", "location") + (
        ("location_joint",) if args.joint_location else ()
    )
    flatten = None if args.vq_flatten is None else args.vq_flatten == "compat"
    res = run_pipeline(
        args.seed, train, val, store_dir=args.store_dir, config=config, width_scale=args.width_scale,
        updates={k: args.updates for k in stages} if args.updates else None,
        preset=args.preset, vq_ema=args.vq_ema, commitment_weight=args.commitment_weight,
        location_input_mode=args.location_input_mode, location_target_mode=args.location_target_mode,
        compat_vq_flatten=flatten, compute_dtype=args.compute_dtype, joint_location=args.joint_location,
        predict_radius=args.predict_radius,
        joint_task_kwargs=(
            {"tail_weight": args.tail_weight, "tail_frac": args.tail_frac} if args.tail_weight else None
        ),
        resume=args.resume, ckpt_every=args.ckpt_every, device=args.device, log_every=args.log_every,
        profile_dir=args.profile_dir, cache_frozen=args.cache_frozen, keep_checkpoints=args.keep_checkpoints,
        mesh=dp, model_parallel=args.model_parallel, sequence_axis="seq" if args.sequence_parallel else None,
        **recipe, **otf_kwargs(args),
    )
    if dp is not None and not dp.lead:
        return  # the first rank evaluates: every rank holds the same weights

    fixed = args.preset == "fixed"
    flatten = flatten if flatten is not None else not fixed
    data = evaluation_set(train, val)
    task = LocationTask(
        config=config, width_scale=args.width_scale,
        input_mode=args.location_input_mode or ("quantized" if fixed else "encodings"),
        target_mode=args.location_target_mode or "normalized_angle", compat_vq_flatten=flatten,
        compute_dtype=args.compute_dtype,
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
            compute_dtype=args.compute_dtype,
        )
        jm = evaluate_joint_location(joint_task, res["location_joint"][0], data, device=args.device)
        print("joint location evaluation:", json.dumps(jm, indent=2), flush=True)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
