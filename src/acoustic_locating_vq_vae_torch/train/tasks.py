"""The two localizer tasks, inference part.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/tasks.py`` for
``LocationTask`` (the frozen localizer, :418-536) and ``JointLocationTask``
(:621-761): model builders, input wiring and output decoding at the JAX
tasks' defaults. Loss methods, caches and the other stages come with the
training slice. Inputs are tensors (the echoed power spectrogram
``(B, F, T)``) rather than a sample batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..data.config import DatasetConfig
from ..dsp.specs import znorm
from ..models.conv_vqvae import ConvolutionalVQVAE
from ..models.location import JointLocationModel, LocationModule

__all__ = ["LocationTask", "JointLocationTask", "rir_model"]


def _scale(v: int, width_scale: float, floor: int = 4) -> int:
    return max(floor, int(v * width_scale))


def rir_model(
    config: DatasetConfig,
    width_scale: float,
    compat_vq_flatten: bool,
    generator: Optional[torch.Generator] = None,
) -> ConvolutionalVQVAE:
    """The RIR branch (tasks.py:274-279, :682-688): the transposed spectrogram's
    500 frames as channels, H = 1024, 2 tied residual layers of width 64,
    D = 64, K = 1024, all scaled by ``width_scale``."""
    s = lambda v: _scale(v, width_scale)
    return ConvolutionalVQVAE(
        in_channels=config.num_frames, num_hiddens=s(1024), embedding_dim=s(64),
        num_residual_layers=2, num_residual_hiddens=s(64), commitment_cost=0.25,
        num_embeddings=s(1024), compat_vq_flatten=compat_vq_flatten, generator=generator,
    )


def _transposed_input(echoed_spec: torch.Tensor) -> torch.Tensor:
    # z-norm over frequency THEN permute (B, F, T) -> (B, T, F) (train_location.py:63-66)
    return znorm(echoed_spec, dim=1).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class LocationTask:
    """Angle regression from the frozen composite's RIR-branch features
    (train_location.py)."""

    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    output_dim: int = 1
    # "encodings": flattened one-hot code assignments (the reference input);
    # "quantized": the RIR-branch quantized latents
    input_mode: str = "encodings"
    # "normalized_angle": theta/pi (the reference target); "sincos": atan2
    target_mode: str = "normalized_angle"
    # None resolves like the JAX composite builder: the compat flatten
    compat_vq_flatten: Optional[bool] = None

    def build_model(self, generator: Optional[torch.Generator] = None) -> LocationModule:
        if self.input_mode == "quantized":
            width = _scale(64, self.width_scale)  # rir embedding_dim
        else:
            width = _scale(1024, self.width_scale)  # rir num_embeddings (K)
        out_dim = 2 if self.target_mode == "sincos" else self.output_dim
        return LocationModule(self.config.num_freq, width, out_dim, generator)

    def build_rir_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        """The composite's RIR branch, the only part the frozen localizer runs."""
        flatten = True if self.compat_vq_flatten is None else self.compat_vq_flatten
        return rir_model(self.config, self.width_scale, flatten, generator)

    def encodings_from_composite(self, rir: ConvolutionalVQVAE, echoed_spec: torch.Tensor) -> torch.Tensor:
        """Frozen RIR-branch features: one-hot encodings reshaped (B, F, K),
        or the quantized latent (B, F, D) (train_location.py:63-74)."""
        _, q, _, enc = rir.get_latent_representation(
            _transposed_input(echoed_spec), need_encodings=self.input_mode == "encodings"
        )
        if self.input_mode == "quantized":
            feats = q.transpose(1, 2)
        else:
            feats = enc.reshape(q.shape[0], self.config.num_freq, -1)
        return feats.detach()

    def decode_angle(self, pred: torch.Tensor) -> torch.Tensor:
        """Model output -> angle in radians."""
        if self.target_mode == "sincos":
            return torch.atan2(pred[:, 0], pred[:, 1])
        return pred.reshape(-1) * math.pi


@dataclasses.dataclass(frozen=True)
class JointLocationTask:
    """RIR encoder + location head fine-tuned together; the deployed
    localizer (``location_joint``)."""

    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    compat_vq_flatten: bool = False  # one-hot-free gradients need vectors
    target_mode: str = "sincos"
    output_dim: int = 1
    # trailing head column: the source radius in meters
    predict_radius: bool = False

    def build_model(self, generator: Optional[torch.Generator] = None) -> JointLocationModel:
        rir = rir_model(self.config, self.width_scale, self.compat_vq_flatten, generator)
        out_dim = 2 if self.target_mode == "sincos" else self.output_dim
        if self.predict_radius:
            out_dim += 1
        return JointLocationModel(rir, self.config.num_freq, out_dim, generator)

    def model_inputs(self, echoed_spec: torch.Tensor) -> Tuple[torch.Tensor]:
        return (_transposed_input(echoed_spec),)

    def decode_angle(self, pred: torch.Tensor) -> torch.Tensor:
        if self.target_mode == "sincos":
            return torch.atan2(pred[:, 0], pred[:, 1])
        return pred[:, 0] * math.pi

    def decode_radius(self, pred: torch.Tensor) -> torch.Tensor:
        """Predicted source radius in meters (the trailing head column)."""
        if not self.predict_radius:
            raise ValueError("decode_radius requires predict_radius=True")
        return pred[:, -1]
