"""The training loop of the single-VQ-VAE stages.

Counterpart of the core of ``acoustic_locating_vq_vae_tpu/train/loop.py``:
``TrainHistory`` (:89-130), the ``Trainer``'s state and optimizer
(:133-296), its step (:423-475) and ``fit`` (:659-737):

* the dataset is resident on the trainer's device; each step samples a fresh
  batch without replacement (the reference's fresh-shuffle
  ``next(iter(loader))``, train_speech.py:57-61) from an explicit CPU
  generator, and bf16-stored arrays are cast to float32 per batch;
* a train step runs the task's loss, its backward and one Adam update
  (``torch.optim.Adam(lr)``: the same update as ``optax.adam(lr)``, eps 1e-8
  outside the square root, bias-corrected);
* with ``val_replaces_train`` every ``eval_every``-th step is an eval step
  that takes the place of a train step (train_speech.py:57,76-87);
* convolutions and matrix products run in full float32 (TF32 off), the
  convolutions with cuDNN's deterministic algorithms (``utils/device.py``).

The mesh, the frozen-latent caches, on-the-fly synthesis, host-staged data,
checkpoints, preemption and profiling come in later slices.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data.dataset import sample_without_replacement
from ..data.synth import SampleBatch
from ..utils.device import deterministic_convs, full_fp32, resolve_device
from .tasks import Task

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
    raises if a card is asked for and none is present."""

    def __init__(
        self,
        task: Task,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        log_every: int = 100,
        val_replaces_train: bool = True,
        verbose: bool = True,
    ):
        self.task = task
        self.device = resolve_device(device)
        self.model = task.build_model(torch.Generator().manual_seed(seed)).to(self.device).train()
        # model.parameters() yields a tied residual block once
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=task.learning_rate)
        self.sample_generator = torch.Generator().manual_seed(seed + 1)
        self.jitter_generator = torch.Generator().manual_seed(seed + 2)
        self.log_every = log_every
        self.val_replaces_train = val_replaces_train
        self.verbose = verbose

    def to_device(self, data: SampleBatch) -> SampleBatch:
        return data.map(lambda a: torch.as_tensor(a).to(self.device))

    def sample(self, data: SampleBatch) -> SampleBatch:
        """A random batch of ``task.batch_size`` distinct rows (the whole set
        if it is smaller), bf16-stored arrays cast to float32."""
        n = int(data.speech_spec.shape[0])
        idx = sample_without_replacement(self.sample_generator, n, min(self.task.batch_size, n))
        idx = idx.to(data.speech_spec.device)
        return data.map(lambda a: a[idx].float() if a.dtype == torch.bfloat16 else a[idx])

    def step(self, batch: SampleBatch, train: bool = True) -> Dict[str, torch.Tensor]:
        """One train step (loss, backward, Adam) or eval step on an already
        sampled batch; returns the metrics as 0-d tensors, ``loss`` among
        them, without waiting for the device."""
        with full_fp32(), deterministic_convs():
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                loss, metrics = self.task.loss(self.model, batch, True, self.jitter_generator)
                loss.backward()
                self.optimizer.step()
            else:
                with torch.no_grad():
                    loss, metrics = self.task.loss(self.model, batch, False, self.jitter_generator)
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
        every ``eval_every``-th step is an eval step on it instead."""
        num_updates = num_updates or self.task.num_updates
        train_data = self.to_device(train_data)
        if val_data is not None:
            val_data = self.to_device(val_data)
        history = TrainHistory()
        t0 = time.perf_counter()
        frames = 0
        for i in range(num_updates):
            is_val = (
                val_data is not None and self.val_replaces_train and (i + 1) % self.task.eval_every == 0
            )
            metrics = self.step(self.sample(val_data if is_val else train_data), train=not is_val)
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
