"""Synthesize a RIR / speech spectrogram dataset on the device and write it
to disk.

    python -m acoustic_locating_vq_vae_torch.cli.generate_dataset --out-dir DIR \\
        [--format npz|pt] [--dataset-size N] [--seed S] [--smoke] [--device cpu]

Counterpart of the JAX package's ``scripts/generate_dataset.py``, the
replacement of the reference's serial CPU generator
``scripts/genereate_dataset.py``. Writes the ``<i>.npz`` files of
``data.save_dataset`` or, with ``--format pt``, the reference's own ``<i>.pt``
pickles, with ``dataset_config.npy``; ``SpecsDataset`` and the pipeline's
``--data-dir`` read either. Prints the synthesis rate in samples/s (the time
between two synchronises of the device, writing excluded).
"""

from __future__ import annotations

import argparse
import time

from .run_pipeline import add_synthesis_args, smoke_config

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--format", choices=["npz", "pt"], default="npz")
    p.add_argument("--fixed-rir", action="store_true", help="ablation: constant RIR (genereate_dataset.py:12-16)")
    p.add_argument("--fixed-speech", action="store_true", help="ablation: constant utterance")
    p.add_argument("--dataset-size", type=int, default=1000, help="synthetic dataset size (genereate_dataset.py:62)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for a fast end-to-end check (at most 64 samples)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_synthesis_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import torch

    from ..data import DatasetConfig, make_dataset, save_dataset, save_dataset_reference_format
    from ..utils import resolve_device
    from .run_pipeline import load_speech_pool, synthesis_kwargs

    device = resolve_device(args.device)
    config = smoke_config() if args.smoke else DatasetConfig()
    size = min(args.dataset_size, 64) if args.smoke else args.dataset_size
    kw = synthesis_kwargs(args)
    pool = load_speech_pool(args, config)
    if pool is not None:
        kw["speech_pool"] = pool

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    batch = make_dataset(generator, size, config, fixed_rir=args.fixed_rir, fixed_speech=args.fixed_speech,
                         device=device, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"synthesized {size} samples on {device} in {dt:.2f}s ({size / dt:.1f} samples/s)", flush=True)

    write = save_dataset_reference_format if args.format == "pt" else save_dataset
    write(args.out_dir, batch, config)
    print(f"wrote {size} samples + dataset_config.npy to {args.out_dir}", flush=True)


if __name__ == "__main__":
    main()
