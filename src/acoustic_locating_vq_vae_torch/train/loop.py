"""The training loop of every stage.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/loop.py``: ``Preempted``
(:47-62), ``TrainHistory`` (:89-130), the ``Trainer``'s state, optimizer and
frozen composite (:133-319), its step (:423-475), ``request_preemption`` and
``fit`` (:502-737), on-the-fly synthesis (:150-190, :477-500), the resident
field check (:739-753), the frozen-latent cache (:609-633, :783-813) and the
checkpoints (:817-918):

* the dataset is resident on the trainer's device; each step samples a fresh
  batch without replacement (the reference's fresh-shuffle
  ``next(iter(loader))``, train_speech.py:57-61) from an explicit CPU
  generator, and bf16-stored arrays are cast to float32 per batch;
* with ``on_the_fly`` each train step synthesizes a fresh batch on the
  device instead (``data.synthesize_batch`` with ``synth_kwargs``, from a
  synthesis generator on the trainer's device); a RIR bank and a speech pool
  in ``synth_kwargs`` are moved to the device once, when the trainer is made
  or :meth:`Trainer.set_synthesis` is called, and the training set is unused
  (it may be None); eval steps still sample the resident validation set;
* a train step runs the task's loss, its backward and one Adam update
  (``torch.optim.Adam(lr)``: the same update as ``optax.adam(lr)``, eps 1e-8
  outside the square root, bias-corrected). A frozen parameter ends the step
  with no gradient, which Adam skips: the exact zero update that optax gives
  a zero gradient;
* a stage that reads a frozen module outside its model gets it from its task
  (``Task.build_frozen``: the location stage's RIR branch of
  ``composite_params``), held in eval mode outside the optimizer; the task's
  ``step_loss`` and ``step_cache`` are the trainer's one loss path and one
  cache path;
* with ``cache_frozen``, a task with a frozen path (``supports_cache``)
  trains from its frozen branches' code ids, computed once per resident
  dataset and sampled with their rows (under ``on_the_fly`` only the
  validation set's: synthesized batches run the frozen branches);
* with ``val_replaces_train`` every ``eval_every``-th step is an eval step
  that takes the place of a train step (train_speech.py:57,76-87);
* the trainer counts its steps (``step_count``, the JAX ``state.step``, eval steps
  included); ``fit`` runs from it up to ``num_updates``. With a store
  (``checkpoint_dir``) it saves a periodic checkpoint every
  ``task.ckpt_every`` steps and a final one at the end; a checkpoint holds
  the model's state dict (EMA buffers included), Adam's state dict, the step
  and the states of both CPU generators (and under ``on_the_fly`` of the
  synthesis generator), so a resumed run draws the same batches and jitter
  decisions as an uninterrupted one and its steps are bitwise the same;
* SIGTERM during ``fit`` saves a checkpoint at the next step boundary and
  raises :class:`Preempted`; ``fit(resume=True)`` continues from the newest
  periodic checkpoint;
* ``profile_dir`` traces steady-state steps with ``torch.profiler``;
* convolutions and matrix products run in full float32 (TF32 off), the
  convolutions with cuDNN's deterministic algorithms (``utils/device.py``);
  a task with ``compute_dtype="bfloat16"`` runs its conv stacks in bf16 under
  the same deterministic pin (cuDNN raises where it has no deterministic
  algorithm; nothing falls back to float32), while the parameters, Adam's
  state, the checkpoints, the cache's codes and the losses stay float32.

The mesh and host-staged data come in later slices.
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.dataset import sample_without_replacement
from ..data.synth import SampleBatch, synthesize_batch
from ..utils.checkpoint import StageStore
from ..utils.device import deterministic_convs, full_fp32, resolve_device
from ..utils.profiling import trace
from .tasks import Task

Cache = Dict[str, torch.Tensor]

__all__ = ["Trainer", "TrainHistory", "Preempted", "checkpoint_metadata"]

# metadata attributes a checkpoint records where the task has them: the
# evaluation-relevant configuration, which the VQ flatten is without a shape
_META_ATTRS = ("compat_vq_flatten", "input_mode", "target_mode", "predict_radius")


def checkpoint_metadata(task, final: bool) -> dict:
    """The metadata a checkpoint of ``task`` records in the store's manifest:
    the task's name, whether the checkpoint is the stage's final one, and
    the evaluation-relevant modes the task has (``_META_ATTRS``), which the
    deploy entry points read back (``cli.common.apply_stage_eval_config``)."""
    meta: dict = {"task": task.name, "final": final, "has_rng": True}
    for attr in _META_ATTRS:
        if hasattr(task, attr):
            v = getattr(task, attr)
            if attr == "compat_vq_flatten":
                v = True if v is None else bool(v)  # as the task's build_model resolves it
            meta[attr] = v
    return meta


class Preempted(RuntimeError):
    """Raised by :meth:`Trainer.fit` when a preemption signal (SIGTERM)
    arrives mid-stage: the loop saves a periodic checkpoint first, so
    restarting with ``resume=True`` (or the pipeline CLI's ``--resume``)
    loses at most the in-flight step."""

    def __init__(self, task: str, completed: int):
        super().__init__(
            f"stage {task!r} preempted after {completed} updates; checkpoint "
            "saved — restart with resume=True / --resume to continue"
        )
        self.task = task
        self.completed = completed


class TrainHistory:
    """Append-only metric history with reference-style running means
    (print of mean over last 100, train_speech.py:96-103). Values are kept as
    0-d tensors where they were made, so appending does not wait for the card."""

    def __init__(self):
        self.train: Dict[str, List] = {}
        self.val: Dict[str, List] = {}

    def append(self, metrics: Dict[str, torch.Tensor], val: bool):
        store = self.val if val else self.train
        for k, v in metrics.items():
            store.setdefault(k, []).append(v)

    def running_mean(self, key: str, window: int = 100) -> float:
        vals = self.train.get(key, [])
        if not vals:
            return float("nan")
        return float(np.mean([float(v) for v in vals[-window:]]))

    def finalize(self) -> Dict[str, Dict[str, np.ndarray]]:
        as_np = lambda vs: np.asarray([float(v) for v in vs], np.float32)
        return {
            "train": {k: as_np(v) for k, v in self.train.items()},
            "val": {k: as_np(v) for k, v in self.val.items()},
        }

    def save(self, path: str) -> None:
        """Persist metric histories as one .npz of ``<split>/<metric>`` arrays,
        the JAX package's layout."""
        flat = {}
        for split, metrics in self.finalize().items():
            for k, v in metrics.items():
                flat[f"{split}/{k}"] = v
        np.savez(path, **flat)

    @staticmethod
    def load(path: str) -> Dict[str, Dict[str, np.ndarray]]:
        d = np.load(path)
        out: Dict[str, Dict[str, np.ndarray]] = {"train": {}, "val": {}}
        for key in d.files:
            split, name = key.split("/", 1)
            out[split][name] = d[key]
        return out


class Trainer:
    """Trainer for a :class:`..train.tasks.Task` on one device.

    The weights are drawn from ``seed`` on the CPU and moved to ``device``,
    so a run on the card and one on the CPU start alike; batch sampling and
    jitter decisions come from their own CPU generators seeded from
    ``seed + 1`` and ``seed + 2``, on-the-fly synthesis from a generator on
    ``device`` seeded from ``seed + 3``. Runs on the card unless
    ``device="cpu"``; raises if a card is asked for and none is present.

    ``on_the_fly`` synthesizes every train step's batch (see
    :meth:`otf_batch`); ``synth_kwargs`` are its ``synthesize_batch``
    options, with ``rir_bank`` and ``speech_pool`` (n, audio_samples) held on
    the device. Both of those are refused without ``on_the_fly``: a resident
    set draws them when it is made (``make_dataset``).

    ``composite_params`` is the state dict of the composite whose RIR branch
    feeds a :class:`LocationTask` (train_location.py:38,69), required there;
    the trainer holds that branch alone (``frozen_rir``), as the reference
    reads only ``composite_params["rir_model"]``.
    ``cache_frozen`` trains a task with a frozen path from its cached codes
    (see :meth:`build_cache`); it is ignored for a task without one.
    ``checkpoint_dir`` is a :class:`StageStore` root for the stage's
    checkpoints; ``keep_checkpoints`` > 0 keeps only the newest N periodic
    ones (finals are kept). ``profile_dir`` traces steps ``start + 2`` to
    ``start + 7`` of :meth:`fit` into ``<profile_dir>/<task name>.json``."""

    def __init__(
        self,
        task: Task,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        log_every: int = 100,
        val_replaces_train: bool = True,
        verbose: bool = True,
        composite_params: Optional[Mapping[str, torch.Tensor]] = None,
        cache_frozen: bool = False,
        checkpoint_dir: Optional[str] = None,
        keep_checkpoints: int = 0,
        profile_dir: Optional[str] = None,
        on_the_fly: bool = False,
        synth_kwargs: Optional[Mapping] = None,
    ):
        self.task = task
        self.device = resolve_device(device)
        self.on_the_fly = on_the_fly
        self.set_synthesis(synth_kwargs)
        self.frozen_rir = task.build_frozen(composite_params, self.device)
        self.model = task.build_model(torch.Generator().manual_seed(seed)).to(self.device).train()
        # model.parameters() yields a tied residual block once, so Adam's
        # state, keyed by parameter order, is the same for every trainer of
        # the task
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=task.learning_rate)
        self.sample_generator = torch.Generator().manual_seed(seed + 1)
        self.jitter_generator = torch.Generator().manual_seed(seed + 2)
        self.synth_generator = torch.Generator(self.device).manual_seed(seed + 3) if on_the_fly else None
        self.step_count = 0  # steps taken, eval steps included (the JAX state.step)
        self.log_every = log_every
        self.val_replaces_train = val_replaces_train
        self.verbose = verbose
        self.cache_frozen = cache_frozen
        self.store = StageStore(checkpoint_dir) if checkpoint_dir else None
        self.keep_checkpoints = int(keep_checkpoints)
        self.profile_dir = profile_dir
        # set by the SIGTERM handler fit() installs, or request_preemption()
        self._preempt_requested = False

    def set_synthesis(self, synth_kwargs: Optional[Mapping]) -> None:
        """Set the on-the-fly synthesis options (``synth_kwargs`` of the
        constructor): the RIR bank and the speech pool go to the device now,
        once, and every later :meth:`otf_batch` reads them there. The
        synthesis generator keeps its state."""
        self.synth_kwargs = dict(synth_kwargs or {})
        bank = self.synth_kwargs.pop("rir_bank", None)
        pool = self.synth_kwargs.pop("speech_pool", None)
        if not self.on_the_fly and (bank is not None or pool is not None):
            raise ValueError(
                "synth_kwargs rir_bank/speech_pool only apply to on_the_fly training; resident datasets draw from "
                "make_dataset(speech_pool=...) at build time"
            )
        self.rir_bank = None if bank is None else torch.as_tensor(bank).to(self.device)
        self.speech_pool = None
        if pool is not None:
            self.speech_pool = torch.as_tensor(pool, dtype=torch.float32).to(self.device)
            if self.speech_pool.shape[1] != self.task.config.audio_samples:
                raise ValueError(f"speech_pool length {self.speech_pool.shape[1]} != config.audio_samples "
                                 f"{self.task.config.audio_samples}")

    def otf_batch(self) -> SampleBatch:
        """One on-the-fly training batch of ``task.batch_size`` samples,
        synthesized on the device from the synthesis generator: with a
        speech pool, each sample's utterance is a pool row drawn first, then
        ``synthesize_batch`` draws the rest (the order ``make_dataset``
        draws a batch in), from the bank where one is set."""
        gen, b = self.synth_generator, self.task.batch_size
        kw = dict(self.synth_kwargs)
        if self.rir_bank is not None:
            kw["rir_bank"] = self.rir_bank
        if self.speech_pool is not None:
            kw["speech"] = self.speech_pool[torch.randint(self.speech_pool.shape[0], (b,), generator=gen,
                                                          device=gen.device)]
        return synthesize_batch(gen, b, self.task.config, device=self.device, **kw)

    def to_device(self, data: SampleBatch) -> SampleBatch:
        return data.map(lambda a: torch.as_tensor(a).to(self.device))

    def _check_resident_fields(self, data: SampleBatch) -> None:
        """Refuse a dataset pruned of a field this task reads (an empty
        placeholder would fail later as a shape error in a conv)."""
        missing = [f for f in self.task.resident_fields
                   if getattr(data, f).dim() >= 2 and 0 in getattr(data, f).shape[1:]]
        if missing:
            raise ValueError(
                f"dataset was pruned without {missing}, which task {self.task.name!r} reads; "
                f"keep {tuple(self.task.resident_fields)}"
            )

    def _indices(self, data: SampleBatch) -> torch.Tensor:
        n = int(data.speech_spec.shape[0])
        idx = sample_without_replacement(self.sample_generator, n, min(self.task.batch_size, n))
        return idx.to(data.speech_spec.device)

    @staticmethod
    def _rows(data: SampleBatch, idx: torch.Tensor) -> SampleBatch:
        return data.map(lambda a: a[idx].float() if a.dtype == torch.bfloat16 else a[idx])

    def sample(self, data: SampleBatch) -> SampleBatch:
        """A random batch of ``task.batch_size`` distinct rows (the whole set
        if it is smaller), bf16-stored arrays cast to float32."""
        return self._rows(data, self._indices(data))

    def sample_cached(self, data: SampleBatch, cache: Cache) -> Tuple[SampleBatch, Cache]:
        """:meth:`sample` with the cache's rows of the same samples."""
        idx = self._indices(data)
        return self._rows(data, idx), {k: v[idx] for k, v in cache.items()}

    def build_cache(self, data: SampleBatch) -> Cache:
        """The frozen-latent cache of a resident dataset: the task's code ids
        of every row (both branches' for the echoed stage, the RIR branch's
        for the location stage), in chunks of ``min(n, max(B, 8))`` rows with
        bf16-stored rows cast to float32 first, as a step sees them. Valid
        for the whole stage: the cached branches get no gradient, so Adam
        leaves their weights bitwise unchanged, and a resumed stage rebuilds
        the same cache from the same frozen weights."""
        if not self.task.supports_cache:
            raise ValueError(f"task {self.task.name!r} has no frozen path to cache")
        n = int(data.speech_spec.shape[0])
        chunk = min(n, max(int(self.task.batch_size), 8))
        parts = []
        with torch.no_grad(), full_fp32(), deterministic_convs():
            for i in range(0, n, chunk):
                idx = torch.arange(i, min(i + chunk, n), device=data.speech_spec.device)
                parts.append(self.task.step_cache(self.model, self.frozen_rir, self._rows(data, idx)))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _loss(self, batch: SampleBatch, train: bool, cache: Optional[Cache]):
        return self.task.step_loss(self.model, self.frozen_rir, batch, train, self.jitter_generator, cache)

    def step(self, batch: SampleBatch, train: bool = True, cache: Optional[Cache] = None) -> Dict[str, torch.Tensor]:
        """One train step (loss, backward, Adam) or eval step on an already
        sampled batch, from its cache rows where given; returns the metrics
        as 0-d tensors, ``loss`` among them, without waiting for the device.
        Advances the step count."""
        with full_fp32(), deterministic_convs():
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                loss, metrics = self._loss(batch, True, cache)
                loss.backward()
                self.optimizer.step()
            else:
                with torch.no_grad():
                    loss, metrics = self._loss(batch, False, cache)
        self.step_count += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    # ------------------------------------------------------------------- fit

    def request_preemption(self) -> None:
        """Ask the running fit() to checkpoint and raise :class:`Preempted`
        before its next step. Signal-handler-safe (sets a flag only); also
        the path for callers outside the main thread, where fit() cannot
        install its SIGTERM handler."""
        self._preempt_requested = True

    def fit(
        self,
        train_data: SampleBatch,
        val_data: Optional[SampleBatch] = None,
        num_updates: Optional[int] = None,
        resume: bool = False,
        save_final: bool = True,
    ) -> TrainHistory:
        """Run the stage from the trainer's step count up to ``num_updates`` (the
        task's count when 0 or None) over the resident ``train_data``, or,
        ``on_the_fly``, over synthesized batches (``train_data`` is unused
        and may be None, ``val_data`` is required); with ``val_data`` and
        ``val_replaces_train`` every ``eval_every``-th step is an eval step
        on it instead. With ``cache_frozen`` and a task that supports it, the
        cache of each resident dataset is built first.

        With ``resume=True`` and a store, the stage restarts from its newest
        periodic checkpoint (weights, Adam, step and generators), so a crash
        loses at most ``ckpt_every`` updates. ``save_final=False`` leaves out
        the stage-final checkpoint (periodic ones still save).

        While running, SIGTERM triggers graceful preemption: the loop saves a
        resumable checkpoint at the next step boundary and raises
        :class:`Preempted`; nothing is saved before the first step."""
        installed = False
        try:
            prev = signal.signal(signal.SIGTERM, lambda *_: self.request_preemption())
            installed = True
        except ValueError:
            prev = None  # not the main thread: flag-only preemption
        try:
            return self._fit(train_data, val_data, num_updates, resume, save_final)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
            self._preempt_requested = False

    def _fit(self, train_data, val_data, num_updates, resume, save_final) -> TrainHistory:
        num_updates = num_updates or self.task.num_updates
        if train_data is None and not self.on_the_fly:
            raise ValueError("train_data=None requires on_the_fly=True")
        if self.on_the_fly and val_data is None:
            raise ValueError("on-the-fly training still needs val_data (or a small stub)")
        if resume:
            restored = self.restore_latest()
            if restored is not None and self.verbose:
                print(f"[{self.task.name}] resumed at step {restored}", flush=True)
        caching = self.cache_frozen and self.task.supports_cache
        train_cache = None
        if self.on_the_fly:
            train_data = None
        else:
            train_data = self.to_device(train_data)
            self._check_resident_fields(train_data)
            train_cache = self.build_cache(train_data) if caching else None
        val_cache = None
        if val_data is not None:
            val_data = self.to_device(val_data)
            if caching and self.val_replaces_train:
                val_cache = self.build_cache(val_data)
        if self.verbose and caching:
            print(f"[{self.task.name}] frozen-latent cache built", flush=True)
        history = TrainHistory()
        t0 = time.perf_counter()
        frames = 0
        start = self.step_count
        trace_window = (start + 2, min(start + 7, num_updates))  # steady-state steps
        with contextlib.ExitStack() as tracing:
            for i in range(start, num_updates):
                if self._preempt_requested:
                    tracing.close()
                    if self.store is not None and i > start:
                        # the periodic tag convention, so restore_latest finds it
                        self.save_checkpoint(tag=f"{self.task.name}_{i}")
                    raise Preempted(self.task.name, i)
                if self.profile_dir and i == trace_window[0]:
                    tracing.enter_context(trace(self.profile_dir, self.task.name))
                is_val = (
                    val_data is not None and self.val_replaces_train and (i + 1) % self.task.eval_every == 0
                )
                data, cache = (val_data, val_cache) if is_val else (train_data, train_cache)
                if self.on_the_fly and not is_val:
                    batch, rows = self.otf_batch(), None
                elif cache is None:
                    batch, rows = self.sample(data), None
                else:
                    batch, rows = self.sample_cached(data, cache)
                metrics = self.step(batch, train=not is_val, cache=rows)
                if not is_val:
                    # loop.py:710: frames of the nominal batch
                    frames += self.task.batch_size * self.task.config.num_frames
                history.append(metrics, val=is_val)
                if self.profile_dir and trace_window[0] <= i == trace_window[1] - 1:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    tracing.close()
                    if self.verbose:
                        print(f"[{self.task.name}] trace written to {self.profile_dir}", flush=True)
                if self.verbose and (i + 1) % self.log_every == 0:
                    parts = [f"[{self.task.name}] {i + 1} iterations"]
                    parts += [f"{k}: {history.running_mean(k):.4f}" for k in metrics]
                    if frames:
                        parts.append(f"({frames / (time.perf_counter() - t0):.0f} frames/s)")
                    print("  ".join(parts), flush=True)
                if self.store is not None and (i + 1) % self.task.ckpt_every == 0:
                    self.save_checkpoint(tag=f"{self.task.name}_{i + 1}")
        if self.store is not None and save_final:
            self.save_checkpoint(tag=self.task.name, final=True)
        return history

    # ----------------------------------------------------------- checkpoints

    def save_checkpoint(self, tag: str, final: bool = False) -> None:
        """Save the trainer's state under ``tag``, with the task's
        evaluation-relevant configuration as metadata; then retire all but
        the newest ``keep_checkpoints`` periodic checkpoints of the task."""
        tree = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step_count,
            "sample_generator": self.sample_generator.get_state(),
            "jitter_generator": self.jitter_generator.get_state(),
        }
        if self.on_the_fly:
            tree["synth_generator"] = self.synth_generator.get_state()
        self.store.save_stage(tag, tree, step=self.step_count, metadata=checkpoint_metadata(self.task, final))
        if not final and self.keep_checkpoints > 0:
            prefix = f"{self.task.name}_"
            periodic = sorted(
                ((t, m) for t, m in self.store.stages().items()
                 if t.startswith(prefix) and t[len(prefix):].isdigit()),
                key=lambda x: _ckpt_rank(x[1]),
            )
            for t, _ in periodic[: -self.keep_checkpoints]:
                self.store.delete_stage(t)

    def load_stage_params(self, name: str) -> Dict[str, torch.Tensor]:
        """The model state dict of stage ``name`` in the store (on the CPU)."""
        return self.store.load_stage(name)["model"]

    def restore_latest(self) -> Optional[int]:
        """Load the newest periodic checkpoint of this task from the store
        into the trainer (weights, Adam, step, generators) and return the
        completed updates, or None when there is none. "Newest" is by
        :func:`_ckpt_rank`, the ranking the GC retires by, so resume never
        picks a tag the GC is about to delete, nor a previous run's stale
        higher-step tag."""
        if self.store is None:
            return None
        prefix = f"{self.task.name}_"
        best = None
        for tag, meta in self.store.stages().items():
            if tag.startswith(prefix) and tag[len(prefix):].isdigit():
                rank = _ckpt_rank(meta)
                if best is None or rank > best[1]:
                    best = (tag, rank)
        if best is None:
            return None
        tree = self.store.load_stage(best[0])  # on the CPU, where the generators' states live
        if self.on_the_fly and "synth_generator" not in tree:
            raise ValueError(f"checkpoint {best[0]!r} holds no synthesis generator: it was not saved by an "
                             "on-the-fly run, so this one cannot continue its batches")
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.sample_generator.set_state(tree["sample_generator"])
        self.jitter_generator.set_state(tree["jitter_generator"])
        if self.on_the_fly:
            self.synth_generator.set_state(tree["synth_generator"])
        self.step_count = int(tree["step"])
        return self.step_count


def _ckpt_rank(meta: dict):
    """Recency ranking for periodic checkpoints, the one key both the GC
    (retire lowest-ranked) and restore_latest (resume highest-ranked) use.
    Primary: the store's monotonic per-save ``seq`` counter, which survives
    wall-clock steps and a retrain into a store still holding a previous
    run's higher-step tags; then save time, then step."""
    return (meta.get("seq", -1), meta.get("time", meta["step"]))
