"""Disk-backed datasets, batch sampling and host-staged datasets.

Counterpart of ``acoustic_locating_vq_vae_tpu/data/dataset.py``:
``save_dataset`` writes a dataset directory, ``save_dataset_reference_format``
the reference's own ``<i>.pt`` files, and ``SpecsDataset`` reads a directory
of per-sample files (the ``<i>.npz`` files the JAX ``save_dataset`` writes,
or the reference's ``<i>.pt`` tuples) with its ``dataset_config.npy``, with
the reference class's attributes and ``get_source_coordinates``
(specsdataset.py:9-45; JAX :144-191); ``load_all`` stacks them through the
reference collate (``data/collate.py``: samples shorter than ``num_frames``
dropped, the rest truncated) into a :class:`SampleBatch` the trainer keeps
resident. ``HostStagedDataset`` and ``make_host_dataset`` (JAX :248-326) keep
a set in host memory, pinned for the card, and serve it to the trainer in
fixed-size chunks (``Trainer.fit`` rotates them).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .collate import spec_dataset_preprocessing
from .config import DatasetConfig
from .synth import SampleBatch, dataset_batches

__all__ = [
    "HostStagedDataset", "SpecsDataset", "make_host_dataset", "sample_without_replacement", "save_dataset",
    "save_dataset_reference_format",
]


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
        # the reference class's attributes (specsdataset.py:15-26)
        self.fs = cfg["fs"]
        self.receiver_position = cfg["receiver_position"]
        self.room_dimensions = cfg["room_dimensions"]
        self.reverberation_time = cfg["reverberation_time"]
        self.n_sample = cfg["n_sample"]
        self.R = cfg["R"]
        self.NFFT = cfg["NFFT"]
        self.HOP_LENGTH = cfg["HOP_LENGTH"]
        self.Z_LOC_SOURCE = cfg["Z_LOC_SOURCE"]

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

    def get_source_coordinates(self, theta) -> np.ndarray:
        """3-D source position(s) for angle(s) ``theta`` (specsdataset.py:38-45):
        ``R`` from the receiver at height ``Z_LOC_SOURCE``, clipped to the room."""
        theta = np.asarray(theta)
        z = np.full_like(theta, self.Z_LOC_SOURCE, dtype=np.float64)
        pos = np.stack([self.R * np.cos(theta), self.R * np.sin(theta), z], axis=-1) + np.asarray(
            self.receiver_position)
        return np.minimum(pos, np.asarray(self.room_dimensions))

    def load_all(self, num_frames: Optional[int] = None) -> SampleBatch:
        """The whole dataset as one CPU :class:`SampleBatch` through the
        reference collate (:func:`.collate.spec_dataset_preprocessing`):
        samples shorter than ``num_frames`` (default: the config's) are
        dropped, the rest truncated. The radius is the ``.npz`` file's where
        it has one and nothing was dropped, else the config's fixed R."""
        t = num_frames if num_frames is not None else self.config.num_frames
        items = [self[i] for i in range(len(self))]
        stacked = spec_dataset_preprocessing(items, num_frames=t)
        if not isinstance(stacked[0], np.ndarray):
            raise ValueError(
                f"every sample in {self.root_dir} has fewer than {t} time frames; "
                "pass num_frames= explicitly or fix dataset_config"
            )
        n = stacked[0].shape[0]
        radius = np.full((n,), self.config.R, np.float32)
        if n == len(items):
            for i in range(n):
                if os.path.exists(self._npz(i)):
                    d = np.load(self._npz(i))
                    if "radius" in d:
                        radius[i] = float(d["radius"])
        speech, rir, echoed, fs, theta, wiener = (torch.from_numpy(a) for a in stacked)
        return SampleBatch(speech_spec=speech, rir_spec=rir, echoed_spec=echoed, fs=fs, theta=theta.reshape(-1),
                           wiener_est=wiener, radius=torch.from_numpy(radius))


class HostStagedDataset:
    """A dataset in host memory, served to the trainer in fixed-size chunks.

    The reference's largest set (``20k_set``, train_rir.py:121) at about
    1.2 MB a sample does not fit one card as a resident float32 set. This
    class keeps the whole set as CPU tensors (``arrays``) and exposes
    ``chunk(i)``; :meth:`..train.Trainer.fit` holds one chunk on the device,
    samples from it with the unchanged sampler and rotates to the next every
    ``rotate_every`` steps. The device holds TWO chunks for the second half
    of every window, since the trainer copies the next chunk while steps run
    (train/loop.py), so size ``chunk_size`` to at most half the memory to
    spare. ``pin_memory`` pins the arrays (a copy where they are not pinned
    yet; it raises where pinning fails), so that the copies run
    asynchronously; a CUDA trainer refuses a set that is not pinned, and
    :func:`make_host_dataset` allocates its set pinned for a CUDA device. Combine with ``keep_fields`` / ``store_dtype`` to shrink the
    set first."""

    def __init__(self, batch: SampleBatch, chunk_size: int, rotate_every: int = 500, pin_memory: bool = False):
        self.arrays = batch.map(lambda a: torch.as_tensor(a).cpu())
        if pin_memory:
            self.arrays = self.arrays.map(lambda a: a if a.is_pinned() else a.pin_memory())
        self.size = int(self.arrays.theta.shape[0])
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.chunk_size = min(chunk_size, self.size)
        self.num_chunks = -(-self.size // self.chunk_size)
        self.rotate_every = rotate_every

    def chunk(self, i: int) -> SampleBatch:
        """The ``i``-th chunk, cyclic, as views of ``arrays`` (no copy); a
        short tail window slides back so that every chunk has exactly
        ``chunk_size`` rows."""
        lo = (i % self.num_chunks) * self.chunk_size
        lo = min(lo, self.size - self.chunk_size)
        return self.arrays.map(lambda a: a[lo : lo + self.chunk_size])


def make_host_dataset(
    generator: torch.Generator,
    size: int,
    config: DatasetConfig = DatasetConfig(),
    batch: int = 32,
    chunk_size: int = 2000,
    rotate_every: int = 500,
    device="cuda",
    **kwargs,
) -> HostStagedDataset:
    """A ``size``-sample :class:`HostStagedDataset` synthesized on ``device``
    batch by batch, every batch drawn in turn from ``generator`` and copied
    straight into one preallocated host buffer (pinned where ``device`` is a
    card), so the device holds one batch at a time. The set is bitwise
    ``make_dataset(generator, size, config, batch=batch, device=device,
    **kwargs)`` moved to the CPU; ``kwargs`` are :func:`.synth.make_dataset`'s
    (``keep_fields``, ``store_dtype``, ``rir_bank``, ``speech_pool``, the
    synthesis options). ``batch`` defaults to ``make_dataset``'s 32 (JAX: 64),
    so the host set and the resident one agree."""
    device = resolve_device(device)
    pin = device.type == "cuda"
    host = None
    for i, part in dataset_batches(generator, size, config, batch, device=device, **kwargs):
        if host is None:
            host = part.map(lambda a: torch.empty((size,) + tuple(a.shape[1:]), dtype=a.dtype, pin_memory=pin))
        for dst, src in zip(host, part):
            dst[i : i + src.shape[0]].copy_(src)
    return HostStagedDataset(host, chunk_size=chunk_size, rotate_every=rotate_every)
