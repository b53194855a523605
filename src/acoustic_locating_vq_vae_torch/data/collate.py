"""Batch collation (reference: data_preprocessing.py:55-89), the port's own
copy of ``acoustic_locating_vq_vae_tpu/data/collate.py``.

``spec_dataset_preprocessing`` reproduces the reference collate exactly:
samples with fewer than 500 time frames are dropped, the rest truncated to
``[:, :500]``, stacked into batch arrays; six empty lists come back if the
whole batch was dropped (data_preprocessing.py:79-81)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["spec_dataset_preprocessing", "combine_arrays_with_min_dim"]


def spec_dataset_preprocessing(data: Sequence[Tuple], num_frames: int = 500):
    speech_list: List[np.ndarray] = []
    rir_list: List[np.ndarray] = []
    echoed_list: List[np.ndarray] = []
    wiener_list: List[np.ndarray] = []
    theta_list: List[np.ndarray] = []
    fs_list: List[np.ndarray] = []

    for (speech_spec, rir_spec, echoed_spec, fs, theta, wiener_est) in data:
        speech_spec = np.asarray(speech_spec)
        if speech_spec.shape[1] < num_frames:
            continue
        speech_list.append(speech_spec[:, :num_frames])
        rir_list.append(np.asarray(rir_spec)[:, :num_frames])
        echoed_list.append(np.asarray(echoed_spec)[:, :num_frames])
        wiener_list.append(np.asarray(wiener_est))
        theta_list.append(np.asarray(theta))
        fs_list.append(np.asarray(fs))

    if not speech_list:
        return [], [], [], [], [], []
    return (
        np.stack(speech_list),
        np.stack(rir_list),
        np.stack(echoed_list),
        np.stack(fs_list),
        np.stack(theta_list),
        np.stack(wiener_list),
    )


def combine_arrays_with_min_dim(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Legacy min-length complex batching (data_preprocessing.py:19-52): stack
    (1, H, x_i) arrays into (N, H, min_i x_i) complex64."""
    if not arrays:
        raise ValueError("Input list cannot be empty")
    h = arrays[0].shape[1]
    for a in arrays:
        if a.shape[1] != h:
            raise ValueError("All arrays must share the same height (H)")
    min_dim = min(a.shape[2] for a in arrays)
    return np.stack([a[0, :, :min_dim] for a in arrays]).astype(np.complex64)
