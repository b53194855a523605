"""Train the location regressor (stage 5) into the store: the reference's
scripts/train_location.py (an MLP over the frozen composite's RIR-branch
codes predicting theta / pi), or with ``--joint`` the joint stage
(``location_joint``: the RIR encoder fine-tuned with the head).

    python -m acoustic_locating_vq_vae_torch.cli.train_location [--store-dir S] [--updates N] \\
        [--composite-stage finetune|echoed] [--joint [--predict-radius] [--tail-weight W]] [--device cpu]

Counterpart of the JAX package's ``scripts/train_location.py``, with its
flags and its trainer seed, ``--seed`` + 5. The composite comes from
``--composite-stage``, else the store's ``finetune`` stage, else its
``echoed`` one, checked for the VQ flatten. ``--joint
--bank-pretrain-updates N`` (with ``--on-the-fly --rir-bank``) trains the
joint stage by the bank-then-exact recipe (``train.fit_joint_recipe``), run
K's stage 6. The frozen stage's stall near an MSE of 1/3 is noted; the joint
stage ends with its evaluation on the validation set. SIGTERM saves a
checkpoint and exits 75; rerun with ``--resume``.
"""

from __future__ import annotations

import json

from .common import final_metric, stage_parser, stage_setup, task_kwargs, trainer_kwargs
from .run_pipeline import evaluation_set, exit_on_preemption, recipe_kwargs

__all__ = ["main"]


def build_parser():
    p = stage_parser(__doc__.split("\n\n")[0])
    p.add_argument("--composite-stage", default=None,
                   help="stage name of the composite to read latents from (default: finetune if present, else echoed)")
    p.add_argument("--joint", action="store_true",
                   help="beyond the reference: fine-tune the RIR encoder JOINTLY with the location head on the angle "
                   "loss (gradients through the VQ straight-through estimator; codebook frozen). The reference "
                   "freezes the whole composite")
    p.add_argument("--commitment-weight", type=float, default=0.25, help="(--joint) encoder-to-codebook anchor weight")
    p.add_argument("--predict-radius", action="store_true",
                   help="(--joint) append a range output to the head and supervise it with the per-sample source "
                   "radius: 2-D polar localization (angle + distance), meaningful with --radius-range data")
    p.add_argument("--radius-weight", type=float, default=1.0, help="(--predict-radius) weight of the range MSE term")
    p.add_argument("--tail-weight", type=float, default=0.0,
                   help="(--joint) hard-example weighting: add this x the mean of the worst ceil(tail-frac x batch) "
                   "per-sample angle errors to the loss (VALIDATION.md run E); 0 = the runs C-I objective")
    p.add_argument("--tail-frac", type=float, default=0.125,
                   help="(--tail-weight) worst fraction of the batch to weight")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..eval import evaluate_joint_location
    from ..train import JointLocationTask, LocationTask, check_flatten_handoff, fit_joint_recipe, run_stage
    from ..utils import StageStore

    with stage_setup(args, LocationTask().resident_fields) as (config, mesh, train, val):
        lead = mesh is None or mesh.lead
        store = StageStore(args.store_dir)
        stage = args.composite_stage or ("finetune" if store.has_stage("finetune") else "echoed")
        composite = store.load_stage(stage)["model"]
        if lead:
            print(f"using composite from stage {stage!r}", flush=True)
        recipe = recipe_kwargs(args)
        if args.joint:
            kw = task_kwargs(args, config, location=True)
            kw.pop("input_mode", None)  # the joint model always reads dense latents
            task = JointLocationTask(**kw, commitment_weight=args.commitment_weight,
                                     predict_radius=args.predict_radius, radius_weight=args.radius_weight,
                                     tail_weight=args.tail_weight, tail_frac=args.tail_frac)
            check_flatten_handoff(store.stage_metadata(stage), task, stage)
            if recipe:
                trainer, history = fit_joint_recipe(
                    task, args.seed + 5, train, val, args.store_dir, composite, recipe["joint_bank_updates"],
                    args.updates, recipe["joint_exact_synth_kwargs"], args.resume,
                    recipe["joint_polish_bank_prob"], **trainer_kwargs(args, mesh))
            else:
                trainer, history = run_stage(
                    task, args.seed + 5, train, val, args.store_dir, args.updates,
                    initial_params=lambda fresh: task.seed_params(fresh, composite), resume=args.resume,
                    **trainer_kwargs(args, mesh))
        else:
            if recipe:
                raise SystemExit("--bank-pretrain-updates is a --joint recipe")
            task = LocationTask(**task_kwargs(args, config, location=True))
            check_flatten_handoff(store.stage_metadata(stage), task, stage)
            trainer, history = run_stage(task, args.seed + 5, train, val, args.store_dir, args.updates,
                                         composite_params=composite, resume=args.resume, **trainer_kwargs(args, mesh))
        params = trainer.state_dict()
        if not lead:
            return
        target = "(sin,cos)" if getattr(task, "target_mode", "") == "sincos" else "theta/pi"
        mse = final_metric(history, "location_error")
        if mse is None:
            print(f"stage {task.name!r} already at/past {args.updates} updates; nothing to train (--resume)",
                  flush=True)
        else:
            print(f"done: final location MSE {mse:.5f} (target {target}); stage {task.name!r} saved to "
                  f"{args.store_dir}", flush=True)
        if not args.joint and mse is not None and mse > 0.15:
            print("note: a frozen-stage MSE near 0.33 (median ~1.5 rad) is the EXPECTED stall of the reference's "
                  "frozen-composite design (VALIDATION.md runs A/B) — the shipped localizer is the joint stage: "
                  "rerun with --joint (or run_pipeline --joint-location).", flush=True)
        data = evaluation_set(train, val)
        if args.joint and data is not None:
            metrics = evaluate_joint_location(task, params, data, device=args.device)
            print("joint location evaluation:", json.dumps(metrics, indent=2), flush=True)


if __name__ == "__main__":
    with exit_on_preemption():
        main()
