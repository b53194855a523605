"""Train the speech VQ-VAE (stage 1) into the store: the reference's
scripts/train_speech.py.

    python -m acoustic_locating_vq_vae_torch.cli.train_speech [--store-dir S] [--updates N] [--vq-ema] \\
        [--host-staged CHUNK_SIZE --rotate-every R] [--librispeech-dir ROOT] [--device cpu]

Counterpart of the JAX package's ``scripts/train_speech.py``, with its flags
(``cli.common.stage_parser``) and its trainer seed, ``--seed`` + 1. The data
come from ``cli.common.stage_setup`` as in every stage CLI; ``--host-staged``
trains from a set in pinned host memory, a chunk on the card at a time.
SIGTERM saves a checkpoint and exits 75; rerun with ``--resume``.
"""

from __future__ import annotations

from .common import print_recon_done, stage_parser, stage_setup, task_kwargs, trainer_kwargs
from .run_pipeline import exit_on_preemption

__all__ = ["main"]


def main(argv=None) -> None:
    args = stage_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    from ..train import SpeechVQVAETask, run_stage

    with stage_setup(args, SpeechVQVAETask().resident_fields) as (config, mesh, train, val):
        task = SpeechVQVAETask(**task_kwargs(args, config, supports_ema=True, supports_seq=True))
        trainer, history = run_stage(task, args.seed + 1, train, val, args.store_dir, args.updates, resume=args.resume,
                                     **trainer_kwargs(args, mesh))
        if trainer.verbose:
            print_recon_done(history, task.name, args, perplexity=True)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
