"""Dataset configuration: the geometry and spectrogram sizes.

The port's own copy of ``acoustic_locating_vq_vae_tpu/data/config.py:16-80``
(the port imports nothing of the JAX package). Same fields and defaults as the
reference's ``dataset_config.npy`` dict (genereate_dataset.py:55-63,78-88),
and the same writer and reader of that dict.
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

    def to_reference_dict(self) -> dict:
        """The dict layout of dataset_config.npy (genereate_dataset.py:78-88),
        plus the framework extras under keys the reference never reads."""
        return {
            "fs": int(self.fs),
            "receiver_position": list(self.receiver_position),
            "room_dimensions": list(self.room_dimensions),
            "reverberation_time": self.reverberation_time,
            "n_sample": int(self.n_sample),
            "R": self.R,
            "NFFT": int(self.NFFT),
            "HOP_LENGTH": int(self.HOP_LENGTH),
            "Z_LOC_SOURCE": self.Z_LOC_SOURCE,
            "num_frames": int(self.num_frames),
            "audio_samples": int(self.audio_samples),
            "c": self.c,
        }

    @classmethod
    def from_reference_dict(cls, d: dict) -> "DatasetConfig":
        """The config of a ``dataset_config.npy`` dict; the framework extras
        (``num_frames``, ``audio_samples``, ``c``) are read where present."""
        extras = {}
        for key, cast in (("num_frames", int), ("audio_samples", int), ("c", float)):
            if key in d:
                extras[key] = cast(d[key])
        return cls(
            fs=int(d["fs"]),
            receiver_position=tuple(d["receiver_position"]),
            room_dimensions=tuple(d["room_dimensions"]),
            reverberation_time=float(d["reverberation_time"]),
            n_sample=int(d["n_sample"]),
            R=float(d["R"]),
            NFFT=int(d["NFFT"]),
            HOP_LENGTH=int(d["HOP_LENGTH"]),
            Z_LOC_SOURCE=float(d["Z_LOC_SOURCE"]),
            **extras,
        )
