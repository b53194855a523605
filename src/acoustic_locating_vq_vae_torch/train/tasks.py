"""Stage task specs.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/tasks.py``:

* the ``Task`` base (:50-100) and the two single-VQ-VAE training stages,
  ``SpeechVQVAETask`` (:127-189, train_speech.py) and ``RirVQVAETask``
  (:192-257, train_rir.py), with their losses;
* ``LocationTask`` (the frozen localizer, :418-536) and ``JointLocationTask``
  (:621-761), inference part: model builders, input wiring and output
  decoding at the JAX tasks' defaults. Their inputs are tensors (the echoed
  power spectrogram ``(B, F, T)``) rather than a sample batch.

The composite stages, the location losses and the caches come in later
slices; bf16 ``compute_dtype`` and sequence sharding too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..data.config import DatasetConfig
from ..data.synth import SampleBatch
from ..dsp.specs import znorm
from ..models.conv_vqvae import ConvolutionalVQVAE
from ..models.location import JointLocationModel, LocationModule

__all__ = ["Task", "SpeechVQVAETask", "RirVQVAETask", "LocationTask", "JointLocationTask", "rir_model"]


def _scale(v: int, width_scale: float, floor: int = 4) -> int:
    return max(floor, int(v * width_scale))


@dataclasses.dataclass(frozen=True)
class Task:
    """A training stage: model + batch wiring + loss."""

    name: str
    learning_rate: float
    batch_size: int
    num_updates: int
    eval_every: int = 500  # reference's n_samples_test_on_validation_set
    ckpt_every: int = 1000

    def build_model(self, generator: Optional[torch.Generator] = None) -> torch.nn.Module:
        raise NotImplementedError

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        """Positional model inputs extracted from a SampleBatch."""
        raise NotImplementedError

    def loss(
        self, model: torch.nn.Module, batch: SampleBatch, train: bool,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics). ``train`` gates jitter and EMA updates; jitter
        decisions come from ``generator``."""
        raise NotImplementedError


def _apply_vqvae(model: ConvolutionalVQVAE, x: torch.Tensor, train: bool, ema: bool, generator):
    """The JAX ``_apply_vqvae`` (tasks.py:108-120): an EMA codebook updates
    only on training steps (``train_vq=train``); gradient mode keeps the
    reference's always-on q-latent loss value (``train_vq=True``)."""
    return model(x, train=train, train_vq=train if ema else True, generator=generator)


def _vqvae_loss(recon_out, target: torch.Tensor):
    vq_loss, recon, perplexity = recon_out
    recon = recon[..., : target.shape[-1]]  # trim guard (train_speech.py:70-72)
    recon_error = torch.mean((recon - target) ** 2)
    loss = recon_error + vq_loss  # train_speech.py:88, train_rir.py:72
    return loss, {"recon_error": recon_error, "vq_loss": vq_loss, "perplexity": perplexity}


@dataclasses.dataclass(frozen=True)
class SpeechVQVAETask(Task):
    """Clean-speech power-spectrogram reconstruction (train_speech.py):
    H = 1024, 3 tied residual layers of width 1024, D = 128, K = 1024,
    decoder jitter p = 0.25, the reference's memory-order VQ flatten."""

    name: str = "speech"
    learning_rate: float = 1e-3
    batch_size: int = 32
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0  # <1 for smoke/test configs
    vq_ema: bool = False  # EMA codebook (option; gradient mode = reference parity)

    def build_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        s = lambda v: _scale(v, self.width_scale)
        return ConvolutionalVQVAE(
            in_channels=self.config.num_freq, num_hiddens=s(1024), embedding_dim=s(128),
            num_residual_layers=3, num_residual_hiddens=s(1024), commitment_cost=0.25,
            num_embeddings=s(1024), use_jitter=True, vq_ema=self.vq_ema, generator=generator,
        )

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        # abs + z-norm over the freq dim (train_speech.py:63-64)
        return (znorm(torch.abs(batch.speech_spec), dim=1),)

    def loss(self, model, batch, train, generator=None):
        (x,) = self.model_inputs(batch)
        return _vqvae_loss(_apply_vqvae(model, x, train, self.vq_ema, generator), x)


@dataclasses.dataclass(frozen=True)
class RirVQVAETask(Task):
    """RIR VQ-VAE: transposed spectrogram in, Wiener estimate out
    (train_rir.py), with the reference's memory-order VQ flatten."""

    name: str = "rir"
    learning_rate: float = 1e-3
    batch_size: int = 32
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    vq_ema: bool = False

    def build_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        return rir_model(self.config, self.width_scale, True, generator, decoder=True, vq_ema=self.vq_ema)

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        # z-norm over dim 1 THEN permute (B,F,T)->(B,T,F) (train_rir.py:44-45)
        return (znorm(batch.rir_spec, dim=1).transpose(1, 2),)

    def loss(self, model, batch, train, generator=None):
        (x,) = self.model_inputs(batch)
        target = znorm(batch.wiener_est, dim=1)[:, None, :]  # (B,1,F) (train_rir.py:46-49)
        return _vqvae_loss(_apply_vqvae(model, x, train, self.vq_ema, generator), target)


def rir_model(
    config: DatasetConfig,
    width_scale: float,
    compat_vq_flatten: bool,
    generator: Optional[torch.Generator] = None,
    decoder: bool = False,
    vq_ema: bool = False,
) -> ConvolutionalVQVAE:
    """The RIR VQ-VAE (tasks.py:221-237, :274-279, :682-688): the transposed
    spectrogram's 500 frames as channels, H = 1024, 2 tied residual layers of
    width 64, D = 64, K = 1024, all scaled by ``width_scale``; no jitter, one
    output channel. The localizers' branch is its encode half
    (``decoder=False``)."""
    s = lambda v: _scale(v, width_scale)
    return ConvolutionalVQVAE(
        in_channels=config.num_frames, num_hiddens=s(1024), embedding_dim=s(64),
        num_residual_layers=2, num_residual_hiddens=s(64), commitment_cost=0.25,
        num_embeddings=s(1024), compat_vq_flatten=compat_vq_flatten, use_jitter=False,
        out_channels=1, vq_ema=vq_ema, decoder=decoder, generator=generator,
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
