"""Disk-backed datasets and batch sampling.

Counterpart of ``acoustic_locating_vq_vae_tpu/data/dataset.py:40-62``,
``:95-229``: ``save_dataset`` writes a dataset directory,
``save_dataset_reference_format`` the reference's own ``<i>.pt`` files, and
``SpecsDataset`` reads a directory of per-sample files (the
``<i>.npz`` files the JAX ``save_dataset`` writes, or the reference's
``<i>.pt`` tuples) with its ``dataset_config.npy``, and ``load_all`` stacks
them into a :class:`SampleBatch` the trainer keeps resident. The collate is
the port's own copy of the JAX ``data/collate.py`` (the reference's
data_preprocessing.py:55-89): samples shorter than ``num_frames`` are dropped,
the rest truncated.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .config import DatasetConfig
from .synth import SampleBatch

__all__ = ["SpecsDataset", "sample_without_replacement", "save_dataset", "save_dataset_reference_format"]


def sample_without_replacement(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """``k`` distinct indices drawn uniformly from ``[0, n)``, int64 on the
    generator's device."""
    if k > n:
        raise ValueError(f"cannot sample {k} distinct indices from a population of {n}")
    return torch.randperm(n, generator=generator, device=generator.device)[:k]


def save_dataset(root_dir: str, batch: SampleBatch, config: DatasetConfig) -> None:
    """Write a SampleBatch as ``<i>.npz`` files + ``dataset_config.npy``, the
    JAX ``save_dataset`` layout (its ``data/dataset.py:95-111``), which
    :class:`SpecsDataset` and the JAX package read back."""
    os.makedirs(root_dir, exist_ok=True)
    arrs = batch.map(lambda a: torch.as_tensor(a).cpu().numpy())
    for i in range(arrs.speech_spec.shape[0]):
        np.savez(
            os.path.join(root_dir, f"{i}.npz"),
            speech_spec=arrs.speech_spec[i],
            rir_spec=arrs.rir_spec[i],
            echoed_spec=arrs.echoed_spec[i],
            fs=arrs.fs[i],
            theta=arrs.theta[i],
            wiener_est=arrs.wiener_est[i],
            radius=arrs.radius[i],
        )
    np.save(os.path.join(root_dir, "dataset_config.npy"), config.to_reference_dict())


def save_dataset_reference_format(root_dir: str, batch: SampleBatch, config: DatasetConfig) -> None:
    """Write the reference's on-disk format, one ``<i>.pt`` pickle of the
    6-tuple per sample (genereate_dataset.py:97-103; theta as a float64 (1,)
    tensor, fs an int), + ``dataset_config.npy``, so the reference's scripts
    and :class:`SpecsDataset` read it."""
    os.makedirs(root_dir, exist_ok=True)
    arrs = batch.map(lambda a: torch.as_tensor(a).cpu())
    for i in range(arrs.speech_spec.shape[0]):
        sample = (
            arrs.speech_spec[i].clone(),
            arrs.rir_spec[i].clone(),
            arrs.echoed_spec[i].clone(),
            int(arrs.fs[i]),
            arrs.theta[i : i + 1].to(torch.float64),
            arrs.wiener_est[i].clone(),
        )
        torch.save(sample, os.path.join(root_dir, f"{i}.pt"))
    np.save(os.path.join(root_dir, "dataset_config.npy"), config.to_reference_dict())


class SpecsDataset:
    """Map-style dataset over ``<i>.pt`` / ``<i>.npz`` files (specsdataset.py:9-45)."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self.dataset_files = sorted(
            glob.glob(os.path.join(root_dir, "*.pt")) + glob.glob(os.path.join(root_dir, "*.npz"))
        )
        cfg = np.load(os.path.join(root_dir, "dataset_config.npy"), allow_pickle=True).item()
        self.config = DatasetConfig.from_reference_dict(cfg)

    def __len__(self) -> int:
        return len(self.dataset_files)

    def _npz(self, idx: int) -> str:
        return os.path.join(self.root_dir, f"{idx}.npz")

    def __getitem__(self, idx: int) -> Tuple:
        """(speech_spec, rir_spec, echoed_spec, fs, theta (1,), wiener_est) as numpy."""
        if os.path.exists(self._npz(idx)):
            d = np.load(self._npz(idx))
            return (
                d["speech_spec"], d["rir_spec"], d["echoed_spec"], d["fs"].item(),
                np.atleast_1d(d["theta"]), d["wiener_est"],
            )
        item = torch.load(os.path.join(self.root_dir, f"{idx}.pt"), weights_only=False)
        speech_spec, rir_spec, echoed_spec, fs, theta, wiener_est = item
        to_np = lambda x: x.numpy() if hasattr(x, "numpy") else np.asarray(x)
        return (
            to_np(speech_spec), to_np(rir_spec), to_np(echoed_spec),
            int(fs) if np.ndim(fs) == 0 else int(np.asarray(fs).reshape(-1)[0]),
            np.atleast_1d(to_np(theta)), to_np(wiener_est),
        )

    def load_all(self, num_frames: Optional[int] = None) -> SampleBatch:
        """The whole dataset as one CPU :class:`SampleBatch`; samples shorter
        than ``num_frames`` (default: the config's) are dropped, the rest
        truncated. The radius is the ``.npz`` file's where it has one and
        nothing was dropped, else the config's fixed R."""
        t = num_frames if num_frames is not None else self.config.num_frames
        items = [self[i] for i in range(len(self))]
        kept = [it for it in items if np.asarray(it[0]).shape[1] >= t]
        if not kept:
            raise ValueError(
                f"every sample in {self.root_dir} has fewer than {t} time frames; "
                "pass num_frames= explicitly or fix dataset_config"
            )
        n = len(kept)
        radius = np.full((n,), self.config.R, np.float32)
        if n == len(items):
            for i in range(n):
                if os.path.exists(self._npz(i)):
                    d = np.load(self._npz(i))
                    if "radius" in d:
                        radius[i] = float(d["radius"])
        stack = lambda j, trunc: torch.from_numpy(
            np.stack([np.asarray(it[j])[:, :t] if trunc else np.asarray(it[j]) for it in kept])
        )
        return SampleBatch(
            speech_spec=stack(0, True),
            rir_spec=stack(1, True),
            echoed_spec=stack(2, True),
            fs=torch.from_numpy(np.asarray([it[3] for it in kept])),
            theta=stack(4, False).reshape(-1),
            wiener_est=stack(5, False),
            radius=torch.from_numpy(radius),
        )
