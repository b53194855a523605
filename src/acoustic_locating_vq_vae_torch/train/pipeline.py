"""The six-stage training pipeline, chained through a stage store.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/pipeline.py:43-449``: the
reference's stage graph with explicit handoff of state dicts in place of
whole-module pickles,

    speech VQ-VAE ----\\
                       +--> echoed composite --> encoder fine-tune --> location
    rir VQ-VAE -------/                                            \\-> joint location

(reference: train_speech.py + train_rir.py -> train_echoed_speech.py:18-19
loads both -> encoder_training_echoed_model.py:43 reloads the composite ->
train_location.py:38 reads the composite for frozen latents), and the joint
stage's bank-pretrain and exact-polish recipe (:func:`fit_joint_recipe`).

``compute_dtype`` goes to every stage's task, the joint stage's included
(JAX :211, :271, :416). ``mesh`` (a :class:`..parallel.DataParallel` handle)
is the JAX ``mesh`` (:201-232): every stage's trainer trains its rank's share
of each batch, and the mesh's first rank alone writes the store;
``sequence_axis`` shards the time axis of the speech, echoed and finetune
stages (JAX :222, :280) and ``model_parallel`` splits every stage's large
parameters over the model axis. Handoffs pass whole tensors. Not ported:
``vq_backend`` (a CUDA tensor always runs the port's kernel, a CPU tensor its
plain version).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.config import DatasetConfig
from ..data.synth import SampleBatch
from ..utils.checkpoint import StageStore
from .loop import Trainer, TrainHistory
from .tasks import (
    EchoedSpeechTask,
    EncoderFinetuneTask,
    JointLocationTask,
    LocationTask,
    RirVQVAETask,
    SpeechVQVAETask,
    graft_pretrained,
)

__all__ = ["fit_joint_recipe", "run_stage", "run_pipeline", "stage_seed"]

StateDict = Mapping[str, torch.Tensor]


def stage_seed(seed: int, index: int) -> int:
    """The trainer seed of the pipeline's stage ``index`` (0 speech ... 5
    joint), derived from the pipeline's ``seed`` and the index. The JAX
    pipeline splits its key per stage (``random.split(key, 5)``, the joint
    stage ``fold_in(key, 6)``); Philox cannot replay those threefry streams,
    so a run of the port and one of the JAX package start from other weights
    and batches."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def run_stage(
    task,
    seed: int,
    train_data: SampleBatch,
    val_data: Optional[SampleBatch],
    store_dir: Optional[str] = None,
    num_updates: Optional[int] = None,
    initial_params: Union[StateDict, Callable[[StateDict], StateDict], None] = None,
    composite_params: Optional[StateDict] = None,
    resume: bool = False,
    **trainer_kwargs,
) -> Tuple[Trainer, TrainHistory]:
    """Train one stage: a :class:`Trainer` of ``task`` from ``seed``, its
    weights loaded from ``initial_params`` where given (a state dict, or a
    function of the trainer's freshly drawn one: the stage handoffs), copied
    into the trainer's own tensors, so the donor never changes; Adam starts
    fresh. Checkpoints go to ``store_dir``."""
    trainer = Trainer(task, seed=seed, checkpoint_dir=store_dir, composite_params=composite_params, **trainer_kwargs)
    if initial_params is not None:
        if callable(initial_params):
            initial_params = initial_params(trainer.state_dict())
        trainer.load_state_dict(initial_params)
    history = trainer.fit(train_data, val_data, num_updates=num_updates, resume=resume)
    return trainer, history


def fit_joint_recipe(
    task: JointLocationTask,
    seed: int,
    train_data: Optional[SampleBatch],
    val_data: Optional[SampleBatch],
    store_dir: Optional[str],
    composite_params: StateDict,
    bank_updates: int,
    num_updates: Optional[int],
    exact_synth_kwargs: Optional[Dict] = None,
    resume: bool = False,
    polish_bank_prob: float = 0.0,
    **trainer_kwargs,
) -> Tuple[Trainer, TrainHistory]:
    """The joint stage's production recipe in one call (JAX
    ``pipeline.py:70-198``; VALIDATION.md runs G and H): ``bank_updates``
    on-the-fly updates drawn from the RIR bank in
    ``trainer_kwargs["synth_kwargs"]``, then an exact-synthesis polish with
    ``exact_synth_kwargs`` up to ``num_updates`` in all. A :class:`Trainer`
    of ``task`` from ``seed`` starts from the joint handoff of
    ``composite_params``.

    One store and one step count: leg 1 ends without a final checkpoint
    and the boundary is pinned as a periodic one, so the stage reads as
    complete only after the polish; with a store, leg 2 resumes through it
    (the boundary, or a later checkpoint of a preempted polish: weights,
    Adam, step and every generator, the synthesis one included), without
    one it runs the remaining updates. ``resume=True`` restarts inside
    whichever leg a run stopped in (a restore past ``bank_updates`` makes
    leg 1 empty).

    The hard bank-to-exact switch is a distribution shift that roughly
    doubles the training error at the boundary (run J: 0.163 -> 0.315); a
    polish under the measured ~50k re-convergence horizon warns, and
    ``polish_bank_prob`` > 0 softens the boundary: each polish sample draws
    from the bank with that probability (``bank_mix_prob``) and is exact
    otherwise. Returns the trainer and the two legs' merged history."""
    if num_updates is None:
        num_updates = task.num_updates
    if not 0 < bank_updates < num_updates:
        raise ValueError(f"bank_updates must satisfy 0 < bank < total updates, got {bank_updates} of {num_updates}")
    if not 0.0 <= float(polish_bank_prob) < 1.0:
        raise ValueError(f"polish_bank_prob must be in [0, 1), got {polish_bank_prob}")
    polish_updates = num_updates - bank_updates
    if polish_updates < 50_000 and polish_updates < bank_updates:
        # small runs (tests, smoke budgets) shrink both legs together and stay silent
        warnings.warn(
            f"polish leg is {polish_updates} updates — below the measured ~50k re-convergence horizon of the "
            "bank->exact distribution shift (run H re-converged inside 50k; run J's 20k polish ended WORSE than "
            "its bank leg, 0.224 vs 0.163 train error). Either budget >= 50k polish updates or soften the "
            "boundary with polish_bank_prob (--polish-bank-prob).", stacklevel=2)
    synth_kw = trainer_kwargs.get("synth_kwargs") or {}
    if "rir_bank" not in synth_kw:
        raise ValueError("bank pretraining needs a RIR bank in synth_kwargs (CLI: --rir-bank N with --on-the-fly)")
    if (exact_synth_kwargs or {}).get("rir_bank") is not None:
        raise ValueError("exact_synth_kwargs must not carry a rir_bank")
    trainer = Trainer(task, seed=seed, checkpoint_dir=store_dir, **trainer_kwargs)
    trainer.load_state_dict(task.seed_params(trainer.state_dict(), composite_params))
    h1 = trainer.fit(train_data, val_data, num_updates=bank_updates, resume=resume, save_final=False)
    if store_dir:
        # the leg boundary as a periodic tag, so leg 2 resumes there even off the ckpt_every cadence
        trainer.save_checkpoint(tag=f"{task.name}_{trainer.step_count}")
    if trainer.verbose:
        print(f"[{task.name}] bank pretraining done at step {trainer.step_count}; polishing with exact synthesis "
              f"to {num_updates}", flush=True)
    polish = dict(exact_synth_kwargs or {})
    if polish_bank_prob:
        polish.update(rir_bank=trainer.rir_bank, bank_mix_prob=float(polish_bank_prob))
        if "rir_bank_radii" in synth_kw:
            polish["rir_bank_radii"] = synth_kw["rir_bank_radii"]
    trainer.set_synthesis(polish)
    h2 = trainer.fit(train_data, val_data, num_updates=num_updates, resume=bool(store_dir))
    merged = TrainHistory()
    for h in (h1, h2):
        for split in ("train", "val"):
            for k, v in getattr(h, split).items():
                getattr(merged, split).setdefault(k, []).extend(v)
    return trainer, merged


def run_pipeline(
    seed: int,
    train_data: SampleBatch,
    val_data: Optional[SampleBatch],
    store_dir: Optional[str] = None,
    config: DatasetConfig = DatasetConfig(),
    width_scale: float = 1.0,
    updates: Optional[Dict[str, int]] = None,
    preset: str = "compat",
    vq_ema: Optional[bool] = None,
    commitment_weight: Optional[float] = None,
    location_input_mode: Optional[str] = None,
    location_target_mode: Optional[str] = None,
    compat_vq_flatten: Optional[bool] = None,
    compute_dtype: str = "float32",
    joint_location: bool = False,
    predict_radius: bool = False,
    resume: bool = False,
    ckpt_every: Optional[int] = None,
    joint_task_kwargs: Optional[Dict] = None,
    joint_bank_updates: Optional[int] = None,
    joint_exact_synth_kwargs: Optional[Dict] = None,
    joint_polish_bank_prob: float = 0.0,
    mesh=None,
    model_parallel: bool = False,
    sequence_axis: Optional[str] = None,
    **trainer_kwargs,
) -> Dict[str, Tuple[Dict[str, torch.Tensor], Optional[TrainHistory]]]:
    """Run the five stages, and the joint stage with ``joint_location``;
    returns ``{stage: (state_dict, history)}``. The JAX package keeps EMA
    codebook statistics in a separate ``variables`` tree; here they are
    buffers in the state dict. ``trainer_kwargs`` go to every stage's
    :class:`Trainer` (``device``, ``cache_frozen``, ``keep_checkpoints``,
    ``profile_dir``, ``log_every``, ``verbose``, ``on_the_fly``,
    ``synth_kwargs``). Stage ``i`` trains from :func:`stage_seed` ``(seed,
    i)``. ``compute_dtype`` (``"float32"`` or ``"bfloat16"``) is every
    stage's conv-stack compute dtype; the state dicts are float32 either way,
    so a store written in one loads in the other. With ``on_the_fly`` every stage synthesizes its training batches
    (``train_data`` may be None) from ``synth_kwargs``, a RIR bank there
    included; ``joint_bank_updates`` trains the joint stage by
    :func:`fit_joint_recipe`: that many updates from the bank, then the
    polish with ``joint_exact_synth_kwargs`` (``joint_polish_bank_prob``: a
    mixed polish).

    ``resume=True`` (requires ``store_dir``) makes the pipeline crash-safe:
    a stage whose final checkpoint is in the store is skipped (its weights
    reload from the store for the handoff; its history is None), and the
    first incomplete stage restarts from its newest periodic checkpoint.

    ``preset="compat"`` (default) is the reference configuration.
    ``preset="fixed"`` is the JAX package's best validated configuration: the
    finetune stage anchors its encoders with ``commitment_weight=0.25``, the
    location stage reads the quantized RIR latents (``input_mode=
    "quantized"``), and the VQ quantizes channels-last D-vectors
    (``compat_vq_flatten=False``). Explicit keyword arguments override the
    preset field by field.

    ``mesh`` (a :class:`..parallel.DataParallel` handle, every rank calling
    with the same arguments and the whole sets) trains every stage over the
    mesh (``Trainer(mesh=...)``); the mesh's first rank alone writes the store
    and prints, and every rank returns the same state dicts.
    ``sequence_axis`` (``"seq"``) shards the time
    axis of the speech, echoed and finetune stages (the RIR and location
    stages have no long axis; an explicit compat VQ flatten raises there), and
    ``model_parallel`` splits every stage's large parameters over its model
    axis."""
    if preset not in ("compat", "fixed"):
        raise ValueError(f"unknown preset {preset!r}")
    fixed = preset == "fixed"
    vq_ema = bool(vq_ema) if vq_ema is not None else False
    commitment_weight = commitment_weight if commitment_weight is not None else (0.25 if fixed else 0.0)
    location_input_mode = location_input_mode or ("quantized" if fixed else "encodings")
    # the joint stage defaults to the circular sincos target; the frozen
    # location stage keeps theta/pi unless the caller asks otherwise
    joint_target_mode = location_target_mode or "sincos"
    location_target_mode = location_target_mode or "normalized_angle"
    compat_vq_flatten = compat_vq_flatten if compat_vq_flatten is not None else not fixed

    if mesh is not None:
        trainer_kwargs["mesh"] = mesh
    if model_parallel:
        trainer_kwargs["model_parallel"] = True
    lead = mesh is None or mesh.lead
    seq_kw = {"sequence_axis": sequence_axis} if sequence_axis is not None else {}
    updates = updates or {}
    results: Dict[str, Tuple[Dict[str, torch.Tensor], Optional[TrainHistory]]] = {}
    kw: Dict[str, Any] = dict(config=config, width_scale=width_scale, compat_vq_flatten=compat_vq_flatten,
                              compute_dtype=compute_dtype)
    if ckpt_every is not None:
        kw["ckpt_every"] = ckpt_every

    if resume and not store_dir:
        raise ValueError("resume=True requires store_dir")
    store = StageStore(store_dir) if resume else None

    def completed(name: str) -> Optional[Dict[str, torch.Tensor]]:
        """The state dict of the stage's final checkpoint, or None if the
        stage has not finished."""
        if store is None or not store.has_stage(name):
            return None
        meta = store.stage_metadata(name)
        if not meta.get("final"):
            return None
        # The VQ flatten is shape-invisible (identical parameters, codes of
        # another meaning), so a store trained under the other flatten would
        # graft garbage into the downstream stages with no error.
        if "compat_vq_flatten" in meta and bool(meta["compat_vq_flatten"]) != compat_vq_flatten:
            names = {True: "compat", False: "vectors"}
            raise ValueError(
                f"resume: stage {name!r} in {store_dir!r} was trained with the "
                f"{names[bool(meta['compat_vq_flatten'])]!r} VQ flatten but this "
                f"pipeline resolves to {names[compat_vq_flatten]!r} — its codebook "
                "codes mean different things and the handoff would silently "
                "corrupt training. Re-run with the matching --vq-flatten/preset, "
                "or point --store-dir at a fresh store."
            )
        params = store.load_stage(name)["model"]
        if lead:
            print(f"[pipeline] stage {name!r} complete in store — skipping", flush=True)
        return params

    def stage(index: int, task, initial=None, composite_params=None):
        """The stage's final state dict and history: from the store when it
        is complete there, else trained, its weights first set to
        ``initial(fresh state dict)`` where given."""
        done = completed(task.name)
        if done is not None:
            results[task.name] = (done, None)
            return done
        trainer, history = run_stage(task, stage_seed(seed, index), train_data, val_data, store_dir,
                                     updates.get(task.name), initial, composite_params, resume, **trainer_kwargs)
        results[task.name] = (trainer.state_dict(), history)
        return results[task.name][0]

    # Stages 1 and 2: the two VQ-VAEs.
    speech = stage(0, SpeechVQVAETask(**kw, vq_ema=vq_ema, **seq_kw))
    rir = stage(1, RirVQVAETask(**kw, vq_ema=vq_ema))
    # Stage 3: the composite with both grafted as its frozen branches (an EMA
    # donor's codebook becomes the frozen parameter, its statistics dropped).
    # No commitment anchor here: the branch latents get no gradient, so an
    # anchor would be the only gradient reaching the encoders and collapse them.
    echoed = stage(2, EchoedSpeechTask(**kw, **seq_kw), initial=lambda fresh: graft_pretrained(fresh, speech, rir))
    # Stage 4: the encoders fine-tuned, continuing from the composite.
    finetune = stage(3, EncoderFinetuneTask(**kw, commitment_weight=commitment_weight, **seq_kw),
                     initial=lambda fresh: echoed)
    # Stage 5: location regression over the frozen fine-tuned composite.
    stage(4, LocationTask(**kw, input_mode=location_input_mode, target_mode=location_target_mode),
          composite_params=finetune)
    # Stage 6 (``joint_location``): the RIR encoder fine-tuned jointly with a
    # fresh location head on the angle loss, seeded from the fine-tuned
    # composite (the reference's train_location.py:69 freezes the composite).
    if joint_location:
        joint = JointLocationTask(
            config=config, width_scale=width_scale, compat_vq_flatten=compat_vq_flatten,
            compute_dtype=compute_dtype, target_mode=joint_target_mode, predict_radius=predict_radius,
            **({"ckpt_every": ckpt_every} if ckpt_every is not None else {}),
            **(joint_task_kwargs or {}),
        )
        if joint_bank_updates:
            done = completed(joint.name)
            if done is not None:
                results[joint.name] = (done, None)
                return results
            trainer, history = fit_joint_recipe(
                joint, stage_seed(seed, 5), train_data, val_data, store_dir, finetune, joint_bank_updates,
                updates.get(joint.name), joint_exact_synth_kwargs, resume, joint_polish_bank_prob, **trainer_kwargs)
            results[joint.name] = (trainer.state_dict(), history)
        else:
            stage(5, joint, initial=lambda fresh: joint.seed_params(fresh, finetune))
    return results
