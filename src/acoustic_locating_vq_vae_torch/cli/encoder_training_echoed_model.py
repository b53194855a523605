"""Fine-tune the composite's encoders (stage 4) into the store: the
reference's scripts/encoder_training_echoed_model.py (the echoed composite
reloaded, the encoders unfrozen with the codebooks still frozen, lr 1e-5,
5,000 updates).

    python -m acoustic_locating_vq_vae_torch.cli.encoder_training_echoed_model [--store-dir S] \\
        [--updates N] [--commitment-weight W] [--device cpu]

Counterpart of the JAX package's ``scripts/encoder_training_echoed_model.py``,
with its flags and its trainer seed, ``--seed`` + 4. It starts from the
store's ``echoed`` stage (checked for the VQ flatten), or, with JAX's
warning, from a fresh composite. ``--commitment-weight`` defaults to the
reference's 0.0, which lets the unfrozen encoders drift from the frozen
codebooks (VALIDATION.md; the pipeline's fixed preset uses 0.25). SIGTERM
saves a checkpoint and exits 75; rerun with ``--resume``.
"""

from __future__ import annotations

from .common import print_recon_done, stage_parser, stage_setup, task_kwargs, trainer_kwargs
from .run_pipeline import exit_on_preemption

__all__ = ["main"]


def main(argv=None) -> None:
    p = stage_parser(__doc__.split("\n\n")[0])
    p.add_argument("--commitment-weight", type=float, default=0.0,
                   help="anchor the unfrozen encoders to the frozen codebooks (0.0 = the reference, which "
                   "collapses the codebooks, VALIDATION.md; 0.25 recommended)")
    args = p.parse_args(argv)
    from ..train import EncoderFinetuneTask, check_flatten_handoff, run_stage
    from ..utils import StageStore

    with stage_setup(args, EncoderFinetuneTask().resident_fields) as (config, mesh, train, val):
        store = StageStore(args.store_dir)
        task = EncoderFinetuneTask(**task_kwargs(args, config, supports_seq=True),
                                   commitment_weight=args.commitment_weight)
        initial = None
        if store.has_stage("echoed"):
            check_flatten_handoff(store.stage_metadata("echoed"), task, "echoed")
            initial = store.load_stage("echoed")["model"]
        elif mesh is None or mesh.lead:
            print("WARNING: no 'echoed' stage in store; fine-tuning a fresh composite", flush=True)
        trainer, history = run_stage(task, args.seed + 4, train, val, args.store_dir, args.updates,
                                     initial_params=initial, resume=args.resume, **trainer_kwargs(args, mesh))
        if trainer.verbose:
            print_recon_done(history, task.name, args)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
