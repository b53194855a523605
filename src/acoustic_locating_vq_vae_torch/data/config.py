"""Dataset configuration: the geometry and spectrogram sizes the serving path
reads.

The port's own copy of ``acoustic_locating_vq_vae_tpu/data/config.py:16-34``
(the port imports nothing of the JAX package). Same fields and defaults as the
reference's ``dataset_config.npy`` dict (genereate_dataset.py:55-63,78-88).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["DatasetConfig"]


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    fs: int = 16000
    receiver_position: Tuple[float, float, float] = (2.5, 1.5, 1.5)
    room_dimensions: Tuple[float, float, float] = (4.0, 5.0, 3.0)
    reverberation_time: float = 0.4
    n_sample: int = 6400  # int(reverberation_time * fs)
    R: float = 1.0
    NFFT: int = 400  # int(fs * 0.025)
    HOP_LENGTH: int = 160  # int(fs * 0.01)
    Z_LOC_SOURCE: float = 1.0
    c: float = 340.0
    num_frames: int = 500  # fixed truncation length (data_preprocessing.py:64-69)
    audio_samples: int = 80000  # 5 s -> 501 frames -> truncated to 500

    @property
    def num_freq(self) -> int:
        return self.NFFT // 2 + 1  # 201
