"""Train the echoed-speech composite's decoder (stage 3) into the store: the
reference's scripts/train_echoed_speech.py.

    python -m acoustic_locating_vq_vae_torch.cli.train_echoed_speech [--store-dir S] [--updates N] \\
        [--cache-frozen] [--device cpu]

Counterpart of the JAX package's ``scripts/train_echoed_speech.py``, with its
flags and its trainer seed, ``--seed`` + 3. The store's ``speech`` and
``rir`` stages are grafted in as the frozen branches (the reference's
pickle loading, train_echoed_speech.py:18-19), each checked for the VQ
flatten the task resolves to; a missing donor leaves its branch freshly
drawn, with JAX's warning. SIGTERM saves a checkpoint and exits 75; rerun
with ``--resume``.
"""

from __future__ import annotations

from .common import print_recon_done, stage_parser, stage_setup, task_kwargs, trainer_kwargs
from .run_pipeline import exit_on_preemption

__all__ = ["main"]


def main(argv=None) -> None:
    args = stage_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    from ..train import EchoedSpeechTask, check_flatten_handoff, graft_pretrained, run_stage
    from ..utils import StageStore

    with stage_setup(args, EchoedSpeechTask().resident_fields) as (config, mesh, train, val):
        store = StageStore(args.store_dir)
        task = EchoedSpeechTask(**task_kwargs(args, config, supports_seq=True))
        donors = {name: store.load_stage(name)["model"] if store.has_stage(name) else None
                  for name in ("speech", "rir")}
        lead = mesh is None or mesh.lead
        if None in donors.values() and lead:
            print("WARNING: missing pretrained speech/rir stage in store; using fresh init", flush=True)
        for name, params in donors.items():
            if params is not None:
                check_flatten_handoff(store.stage_metadata(name), task, name)
        trainer, history = run_stage(
            task, args.seed + 3, train, val, args.store_dir, args.updates,
            initial_params=lambda fresh: graft_pretrained(fresh, donors["speech"], donors["rir"]),
            resume=args.resume, **trainer_kwargs(args, mesh))
        if trainer.verbose:
            print_recon_done(history, task.name, args)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
