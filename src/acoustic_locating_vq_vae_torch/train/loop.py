"""The training loop of every stage.

Counterpart of the core of ``acoustic_locating_vq_vae_tpu/train/loop.py``:
``TrainHistory`` (:89-130), the ``Trainer``'s state, optimizer and frozen
composite (:133-319), its step (:423-475), ``fit`` (:659-737), the resident
field check (:739-753) and the frozen-latent cache (:609-633, :783-813):

* the dataset is resident on the trainer's device; each step samples a fresh
  batch without replacement (the reference's fresh-shuffle
  ``next(iter(loader))``, train_speech.py:57-61) from an explicit CPU
  generator, and bf16-stored arrays are cast to float32 per batch;
* a train step runs the task's loss, its backward and one Adam update
  (``torch.optim.Adam(lr)``: the same update as ``optax.adam(lr)``, eps 1e-8
  outside the square root, bias-corrected). A frozen parameter ends the step
  with no gradient, which Adam skips: the exact zero update that optax gives
  a zero gradient;
* the location stage reads the RIR branch of a frozen composite
  (``composite_params``), held in eval mode outside the optimizer;
* with ``cache_frozen``, a task with a frozen path (``supports_cache``)
  trains from its frozen branches' code ids, computed once per resident
  dataset and sampled with their rows;
* with ``val_replaces_train`` every ``eval_every``-th step is an eval step
  that takes the place of a train step (train_speech.py:57,76-87);
* convolutions and matrix products run in full float32 (TF32 off), the
  convolutions with cuDNN's deterministic algorithms (``utils/device.py``).

The mesh, on-the-fly synthesis, host-staged data, checkpoints, preemption and
profiling come in later slices.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.dataset import sample_without_replacement
from ..data.synth import SampleBatch
from ..utils.device import deterministic_convs, full_fp32, resolve_device
from .tasks import LocationTask, Task

Cache = Dict[str, torch.Tensor]

__all__ = ["Trainer", "TrainHistory"]


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
    ``seed + 1`` and ``seed + 2``. Runs on the card unless ``device="cpu"``;
    raises if a card is asked for and none is present.

    ``composite_params`` is the state dict of the composite whose RIR branch
    feeds a :class:`LocationTask` (train_location.py:38,69), required there;
    the trainer holds that branch alone (``frozen_rir``), as the reference
    reads only ``composite_params["rir_model"]``.
    ``cache_frozen`` trains a task with a frozen path from its cached codes
    (see :meth:`build_cache`); it is ignored for a task without one."""

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
    ):
        self.task = task
        self.device = resolve_device(device)
        self.frozen_rir = None
        if isinstance(task, LocationTask):
            if composite_params is None:
                raise ValueError("LocationTask requires composite_params")
            self.frozen_rir = self._frozen_rir(composite_params)
        self.model = task.build_model(torch.Generator().manual_seed(seed)).to(self.device).train()
        # model.parameters() yields a tied residual block once
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=task.learning_rate)
        self.sample_generator = torch.Generator().manual_seed(seed + 1)
        self.jitter_generator = torch.Generator().manual_seed(seed + 2)
        self.log_every = log_every
        self.val_replaces_train = val_replaces_train
        self.verbose = verbose
        self.cache_frozen = cache_frozen

    def _frozen_rir(self, params: Mapping[str, torch.Tensor]) -> torch.nn.Module:
        """The composite's RIR branch without its never-run decoder, from the
        ``rir_model.*`` entries of ``params`` (copies; every key of the branch
        required), on the trainer's device, in eval mode and without
        gradients."""
        with torch.device("meta"):  # no weights are drawn only to be overwritten
            rir = self.task.build_rir_model()
        prefix = "rir_model."
        rir.load_state_dict(
            {k[len(prefix):]: torch.as_tensor(v).to(self.device, torch.float32, copy=True)
             for k, v in params.items() if k.startswith(prefix) and not k.startswith(prefix + "_decoder.")},
            assign=True,
        )
        return rir.eval().requires_grad_(False)

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
        leaves their weights bitwise unchanged."""
        if not self.task.supports_cache:
            raise ValueError(f"task {self.task.name!r} has no frozen path to cache")
        # the location stage reads the composite's RIR branch, the echoed stage its own branches
        frozen = self.model if self.frozen_rir is None else self.frozen_rir
        n = int(data.speech_spec.shape[0])
        chunk = min(n, max(int(self.task.batch_size), 8))
        parts = []
        with torch.no_grad(), full_fp32(), deterministic_convs():
            for i in range(0, n, chunk):
                idx = torch.arange(i, min(i + chunk, n), device=data.speech_spec.device)
                parts.append(self.task.build_cache(frozen, self._rows(data, idx)))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _loss(self, batch: SampleBatch, train: bool, cache: Optional[Cache]):
        task = self.task
        if self.frozen_rir is not None:
            rir = self.frozen_rir
            with torch.no_grad():
                if cache is not None:
                    feats = task.feats_from_codes(rir, cache)
                else:
                    feats = task.encodings_from_composite(rir, batch.echoed_spec)
            return task.loss(self.model, batch, train, self.jitter_generator, feats=feats)
        if cache is not None:
            return task.loss_cached(self.model, batch, cache, train, self.jitter_generator)
        return task.loss(self.model, batch, train, self.jitter_generator)

    def step(self, batch: SampleBatch, train: bool = True, cache: Optional[Cache] = None) -> Dict[str, torch.Tensor]:
        """One train step (loss, backward, Adam) or eval step on an already
        sampled batch, from its cache rows where given; returns the metrics
        as 0-d tensors, ``loss`` among them, without waiting for the device."""
        with full_fp32(), deterministic_convs():
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                loss, metrics = self._loss(batch, True, cache)
                loss.backward()
                self.optimizer.step()
            else:
                with torch.no_grad():
                    loss, metrics = self._loss(batch, False, cache)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def fit(
        self,
        train_data: SampleBatch,
        val_data: Optional[SampleBatch] = None,
        num_updates: Optional[int] = None,
    ) -> TrainHistory:
        """Run ``num_updates`` steps (the task's count by default) over the
        resident ``train_data``; with ``val_data`` and ``val_replaces_train``
        every ``eval_every``-th step is an eval step on it instead. With
        ``cache_frozen`` and a task that supports it, the cache of each
        dataset is built first."""
        num_updates = num_updates or self.task.num_updates
        caching = self.cache_frozen and self.task.supports_cache
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
        for i in range(num_updates):
            is_val = (
                val_data is not None and self.val_replaces_train and (i + 1) % self.task.eval_every == 0
            )
            data, cache = (val_data, val_cache) if is_val else (train_data, train_cache)
            if cache is None:
                batch, rows = self.sample(data), None
            else:
                batch, rows = self.sample_cached(data, cache)
            metrics = self.step(batch, train=not is_val, cache=rows)
            if not is_val:
                # loop.py:710: frames of the nominal batch
                frames += self.task.batch_size * self.task.config.num_frames
            history.append(metrics, val=is_val)
            if self.verbose and (i + 1) % self.log_every == 0:
                parts = [f"[{self.task.name}] {i + 1} iterations"]
                parts += [f"{k}: {history.running_mean(k):.4f}" for k in metrics]
                if frames:
                    parts.append(f"({frames / (time.perf_counter() - t0):.0f} frames/s)")
                print("  ".join(parts), flush=True)
        return history
