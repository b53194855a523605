"""Compare the location models of a stage store on a held-out set: the
frozen location head over each composite (``echoed``, ``finetune``) and,
where the store has it, the joint stage.

    python -m acoustic_locating_vq_vae_torch.cli.compare_location_models --store-dir S \\
        [--stages echoed finetune] [--val-dir V] [--device cpu]

Counterpart of the JAX package's ``scripts/compare_location_models.py`` (the
fixed version of the reference's broken script, C21), over the port's
``eval/compare.py``, with its JSON keys: theta and 3-D coordinate errors per
model. The checkpoints' metadata decide the trained modes
(``cli.common.apply_stage_eval_config``).
"""

from __future__ import annotations

import json

from .common import apply_stage_eval_config, base_parser, load_datasets, task_kwargs

__all__ = ["build_parser", "main"]


def build_parser():
    p = base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--stages", nargs="*", default=None,
                   help="composite stage names to compare (default: every one the store has of echoed, finetune)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    config, train, val = load_datasets(args)
    eval_data = val if val is not None else train

    from ..eval import compare_location_models, evaluate_joint_location
    from ..train import JointLocationTask, LocationTask
    from ..utils import StageStore

    store = StageStore(args.store_dir)
    if not store.has_stage("location"):
        raise SystemExit("no 'location' stage in the store; run the pipeline first")
    loc_params = store.load_stage("location")["model"]
    stages = args.stages or [s for s in ("echoed", "finetune") if store.has_stage(s)]
    kw = task_kwargs(args, config, location=True)
    apply_stage_eval_config(kw, store, "location", head_params=loc_params, probe_task=LocationTask(**kw))
    task = LocationTask(**kw)
    entries = {
        s: {"location_params": loc_params, "composite_params": store.load_stage(s)["model"], "task": task}
        for s in stages
    }
    results = compare_location_models(entries, eval_data, device=args.device)

    # the joint stage, where the store has it (the configuration VALIDATION.md shows beating the frozen designs)
    if store.has_stage("location_joint"):
        jp = store.load_stage("location_joint")["model"]
        jkw = task_kwargs(args, config, location=True)
        jkw.pop("input_mode", None)  # the joint model always reads dense latents
        apply_stage_eval_config(jkw, store, "location_joint", head_params=jp,
                                keys=("compat_vq_flatten", "target_mode", "predict_radius"),
                                flatten_default="vectors")
        results["location_joint"] = evaluate_joint_location(JointLocationTask(**jkw), jp, eval_data,
                                                            device=args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
