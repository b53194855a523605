"""The sample batch the training stages read.

Counterpart of ``acoustic_locating_vq_vae_tpu/data/synth.py:111-131``
(``SampleBatch``) only; on-device synthesis of batches comes in a later
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SampleBatch"]


class SampleBatch(NamedTuple):
    """The reference 6-tuple (specsdataset.py:31-36) plus the per-sample
    source radius, as tensors: power spectrograms truncated to the fixed
    500-frame geometry."""

    speech_spec: torch.Tensor  # (B, F, T)
    rir_spec: torch.Tensor  # (B, F, T)
    echoed_spec: torch.Tensor  # (B, F, T)
    fs: torch.Tensor  # (B,)
    theta: torch.Tensor  # (B,)
    wiener_est: torch.Tensor  # (B, F)
    radius: torch.Tensor  # (B,)

    def as_tuple(self):
        return (self.speech_spec, self.rir_spec, self.echoed_spec, self.fs, self.theta, self.wiener_est)

    def map(self, fn) -> "SampleBatch":
        """A batch of ``fn`` applied to every field."""
        return SampleBatch(*(fn(t) for t in self))
