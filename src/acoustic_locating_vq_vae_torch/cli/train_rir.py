"""Train the RIR VQ-VAE (stage 2) into the store: the reference's
scripts/train_rir.py.

    python -m acoustic_locating_vq_vae_torch.cli.train_rir [--store-dir S] [--updates N] [--vq-ema] [--device cpu]

Counterpart of the JAX package's ``scripts/train_rir.py``, with its flags
(``cli.common.stage_parser``) and its trainer seed, ``--seed`` + 2.
``--sequence-parallel`` does not apply: the RIR stage's conv length is the
short frequency axis. SIGTERM saves a checkpoint and exits 75; rerun with
``--resume``.
"""

from __future__ import annotations

from .common import print_recon_done, stage_parser, stage_setup, task_kwargs, trainer_kwargs
from .run_pipeline import exit_on_preemption

__all__ = ["main"]


def main(argv=None) -> None:
    args = stage_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    from ..train import RirVQVAETask, run_stage

    with stage_setup(args, RirVQVAETask().resident_fields) as (config, mesh, train, val):
        task = RirVQVAETask(**task_kwargs(args, config, supports_ema=True))
        trainer, history = run_stage(task, args.seed + 2, train, val, args.store_dir, args.updates, resume=args.resume,
                                     **trainer_kwargs(args, mesh))
        if trainer.verbose:
            print_recon_done(history, task.name, args, perplexity=True)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
