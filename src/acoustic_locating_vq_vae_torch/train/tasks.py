"""Stage task specs.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/tasks.py``:

* the ``Task`` base (:50-100) and the two single-VQ-VAE training stages,
  ``SpeechVQVAETask`` (:127-189, train_speech.py) and ``RirVQVAETask``
  (:192-257, train_rir.py), with their losses;
* the two composite stages over the echoed-speech model (:260-414),
  ``EchoedSpeechTask`` (train_echoed_speech.py) and ``EncoderFinetuneTask``
  (encoder_training_echoed_model.py), with the frozen-latent cache
  (``build_cache`` / ``loss_cached``);
* the two location stages, ``LocationTask`` (the frozen localizer,
  train_location.py, :417-539) and ``JointLocationTask`` (:620-761), with
  their losses, the location cache and the serving path's input wiring and
  output decoding;
* ``CodecTask``: the EnCodec neural audio codec (``models/encodec.py``),
  beyond the reference and serving only (``eval/serving.py:
  make_codec_serving_fn``): it builds the model and has no loss;
* the stage handoff (``graft_pretrained``, :542-576), the VQ-flatten guard
  (``resolved_vq_flatten``, ``check_flatten_handoff``, :579-617) and
  ``make_task`` (:764-775);
* the trainer's one loss path and one cache path, ``Task.step_loss`` and
  ``Task.step_cache``, with the frozen module a stage reads outside its model
  (``Task.build_frozen``: the location stage's RIR branch, whose features
  ``LocationTask.frozen_features`` computes; the JAX ``Trainer`` branches on
  the task's type at loop.py:245, :304 and :798).

The port's tasks take a model and a batch (weights live in the modules, not
in a parameter tree), and the stage handoff works on state dicts.

``sequence_axis`` (JAX :142-168, :210-214, :263-298, :329-337, :671-674)
names the mesh axis that shards the time axis of the speech, echoed and
finetune stages (the trainer's mesh supplies it); it resolves the VQ flatten
to the vectors one where ``compat_vq_flatten`` is None, and an explicit
compat flatten raises in the model. The RIR and the two location stages refuse
it: their conv length is the short frequency axis.

Every stage takes ``compute_dtype`` (JAX :138, :203, :314, :428, :637):
``"float32"`` (the default) or ``"bfloat16"``, the compute dtype of its conv
stacks (``models/conv_vqvae.py``); the location stage's frozen RIR branch and
the joint stage's RIR encoder compute in it, the location head stays float32.
Parameters, optimizer state, losses and metrics stay float32, and the VQ
assignment is exact float32 on the latent cast back to float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.config import DatasetConfig
from ..data.synth import SampleBatch
from ..dsp.specs import znorm
from ..models.conv_vqvae import ConvolutionalVQVAE
from ..models.echoed_speech import EchoedSpeechReconModel
from ..models.encodec import EncodecModel
from ..models.location import JointLocationModel, LocationModule

__all__ = [
    "Task", "SpeechVQVAETask", "RirVQVAETask", "EchoedSpeechTask", "EncoderFinetuneTask", "LocationTask",
    "JointLocationTask", "CodecTask", "rir_model", "speech_model", "graft_pretrained", "resolved_vq_flatten",
    "check_flatten_handoff", "make_task",
]

StateDict = Mapping[str, torch.Tensor]


def _scale(v: int, width_scale: float, floor: int = 4) -> int:
    return max(floor, int(v * width_scale))


_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> Optional[torch.dtype]:
    """The conv stacks' compute dtype of a task's ``compute_dtype`` (JAX
    :104-105): None (float32) or ``torch.bfloat16``; raises on any other name."""
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Task:
    """A training stage: model + batch wiring + loss."""

    name: str
    learning_rate: float
    batch_size: int
    num_updates: int
    eval_every: int = 500  # reference's n_samples_test_on_validation_set
    ckpt_every: int = 1000

    def __post_init__(self):
        _dtype(getattr(self, "compute_dtype", "float32"))  # an unknown compute dtype fails here, not mid-stage

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

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        """SampleBatch fields this task's loss reads; the trainer refuses a
        resident dataset pruned of one of them."""
        return SampleBatch._fields

    @property
    def supports_cache(self) -> bool:
        """Whether the task has a frozen path the trainer may cache
        (``build_cache`` with ``loss_cached`` or ``feats_from_codes``)."""
        return False

    def build_frozen(
        self, composite_params: Optional[StateDict], device: torch.device
    ) -> Optional[torch.nn.Module]:
        """The frozen module outside the trained model that the stage reads,
        built from ``composite_params``; None for a stage that reads none."""
        return None

    def step_loss(
        self, model: torch.nn.Module, frozen: Optional[torch.nn.Module], batch: SampleBatch, train: bool,
        generator: Optional[torch.Generator] = None, cache: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The trainer's loss of a step: from the batch's cache rows where
        given (``loss_cached``), else from the batch (``loss``)."""
        if cache is not None:
            return self.loss_cached(model, batch, cache, train, generator)
        return self.loss(model, batch, train, generator)

    def step_cache(
        self, model: torch.nn.Module, frozen: Optional[torch.nn.Module], batch: SampleBatch
    ) -> Dict[str, torch.Tensor]:
        """The cache rows of ``batch``, read from the module that holds the
        frozen path: the model's own frozen branches."""
        return self.build_cache(model, batch)


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
    decoder jitter p = 0.25."""

    name: str = "speech"
    learning_rate: float = 1e-3
    batch_size: int = 32
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0  # <1 for smoke/test configs
    compute_dtype: str = "float32"  # "bfloat16": the conv stacks in bf16
    vq_ema: bool = False  # EMA codebook (option; gradient mode = reference parity)
    # the mesh axis sharding the time axis (long-sequence training); implies the vectors VQ flatten
    sequence_axis: Optional[str] = None
    # None resolves to the reference's memory-order flatten, or to the vectors one under sequence_axis
    compat_vq_flatten: Optional[bool] = None

    def build_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        return speech_model(self.config, self.width_scale, resolved_vq_flatten(self), generator, vq_ema=self.vq_ema,
                            compute_dtype=self.compute_dtype, sequence_axis=self.sequence_axis)

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        return ("speech_spec", "fs", "theta")

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        # abs + z-norm over the freq dim (train_speech.py:63-64)
        return (znorm(torch.abs(batch.speech_spec), dim=1),)

    def loss(self, model, batch, train, generator=None):
        (x,) = self.model_inputs(batch)
        return _vqvae_loss(_apply_vqvae(model, x, train, self.vq_ema, generator), x)


@dataclasses.dataclass(frozen=True)
class RirVQVAETask(Task):
    """RIR VQ-VAE: transposed spectrogram in, Wiener estimate out
    (train_rir.py)."""

    name: str = "rir"
    learning_rate: float = 1e-3
    batch_size: int = 32
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    compute_dtype: str = "float32"
    vq_ema: bool = False
    # present for symmetry but refused: the conv length is the 201-bin frequency axis (the transposed
    # spectrogram) and the z-norm reduces over it, so a shard would normalise with its own statistics
    sequence_axis: Optional[str] = None
    compat_vq_flatten: Optional[bool] = None  # None: the reference's memory-order flatten

    def build_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        if self.sequence_axis is not None:
            raise ValueError("RirVQVAETask does not support sequence parallelism: its conv length is the short freq "
                             "axis and its z-norm reduces over it; use it on the speech/echoed/finetune stages")
        return rir_model(self.config, self.width_scale, resolved_vq_flatten(self), generator, decoder=True,
                         vq_ema=self.vq_ema, compute_dtype=self.compute_dtype)

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        return ("rir_spec", "wiener_est", "fs", "theta")

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
    compute_dtype: str = "float32",
) -> ConvolutionalVQVAE:
    """The RIR VQ-VAE (tasks.py:221-237, :274-279, :682-688): the transposed
    spectrogram's 500 frames as channels, H = 1024, 2 tied residual layers of
    width 64, D = 64, K = 1024, all scaled by ``width_scale``; no jitter, one
    output channel; its convs in ``compute_dtype``. The localizers' branch is
    its encode half (``decoder=False``)."""
    s = lambda v: _scale(v, width_scale)
    return ConvolutionalVQVAE(
        in_channels=config.num_frames, num_hiddens=s(1024), embedding_dim=s(64),
        num_residual_layers=2, num_residual_hiddens=s(64), commitment_cost=0.25,
        num_embeddings=s(1024), compat_vq_flatten=compat_vq_flatten, use_jitter=False,
        out_channels=1, vq_ema=vq_ema, decoder=decoder, generator=generator, compute_dtype=_dtype(compute_dtype),
    )


def speech_model(
    config: DatasetConfig,
    width_scale: float,
    compat_vq_flatten: bool,
    generator: Optional[torch.Generator] = None,
    vq_ema: bool = False,
    compute_dtype: str = "float32",
    sequence_axis: Optional[str] = None,
) -> ConvolutionalVQVAE:
    """The speech VQ-VAE (tasks.py:150-170, :280-286): 201 -> H = 1024, 3 tied
    residual layers of width 1024, D = 128, K = 1024, all scaled by
    ``width_scale``; decoder jitter p = 0.25; its convs in ``compute_dtype``;
    its time axis sharded over ``sequence_axis`` where one is named."""
    s = lambda v: _scale(v, width_scale)
    return ConvolutionalVQVAE(
        in_channels=config.num_freq, num_hiddens=s(1024), embedding_dim=s(128),
        num_residual_layers=3, num_residual_hiddens=s(1024), commitment_cost=0.25,
        num_embeddings=s(1024), compat_vq_flatten=compat_vq_flatten, use_jitter=True,
        vq_ema=vq_ema, generator=generator, compute_dtype=_dtype(compute_dtype), sequence_axis=sequence_axis,
    )


def _echoed_model(
    config: DatasetConfig, width_scale: float, compat_vq_flatten: bool,
    generator: Optional[torch.Generator] = None, compute_dtype: str = "float32",
    sequence_axis: Optional[str] = None,
) -> EchoedSpeechReconModel:
    """The composite (tasks.py:260-299): both branches in one flatten mode,
    so the stage handoff keeps the codes' meaning, and the decoder of
    train_echoed_speech.py:23-27 (H = 1024, 2 tied residual layers of width
    1024, jitter on, the spectrogram's bins out); the branches and the
    decoder in one ``compute_dtype``; the speech branch and the decoder
    time-sharded over ``sequence_axis`` where one is named."""
    s = lambda v: _scale(v, width_scale)
    return EchoedSpeechReconModel(
        rir_model=rir_model(config, width_scale, compat_vq_flatten, generator, decoder=True,
                            compute_dtype=compute_dtype),
        speech_model=speech_model(config, width_scale, compat_vq_flatten, generator, compute_dtype=compute_dtype,
                                  sequence_axis=sequence_axis),
        out_channels=config.num_freq, num_hiddens=s(1024), num_residual_layers=2,
        num_residual_hiddens=s(1024), use_jitter=True, generator=generator, compute_dtype=_dtype(compute_dtype),
        sequence_axis=sequence_axis,
    )


@dataclasses.dataclass(frozen=True)
class EchoedSpeechTask(Task):
    """Frozen-encoder composite: train the fresh decoder to reconstruct the
    echoed spectrogram (train_echoed_speech.py); B = 64, lr 1e-3."""

    name: str = "echoed"
    learning_rate: float = 1e-3
    batch_size: int = 64
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    compute_dtype: str = "float32"
    train_encoder: bool = False
    # Weight on the branch VQ losses (their commitment terms) added to the
    # recon loss; 0.0 is the reference's recon-only loss. It anchors unfrozen
    # encoders to the frozen codebooks (the JAX package's VALIDATION.md).
    commitment_weight: float = 0.0
    # the mesh axis sharding the speech time axis: the speech branch and the decoder run time-sharded, the RIR
    # branch gathers its transposed input; implies the vectors VQ flatten
    sequence_axis: Optional[str] = None
    # None resolves to the reference's memory-order flatten, or to the vectors
    # one under sequence_axis; one flag governs both branches
    compat_vq_flatten: Optional[bool] = None

    def build_model(self, generator: Optional[torch.Generator] = None) -> EchoedSpeechReconModel:
        return _echoed_model(self.config, self.width_scale, resolved_vq_flatten(self), generator, self.compute_dtype,
                             self.sequence_axis)

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        return ("echoed_spec", "fs", "theta")

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        x = znorm(batch.echoed_spec, dim=1)  # train_echoed_speech.py:64
        return x, x.transpose(1, 2)

    def _recon_loss(self, out, x: torch.Tensor):
        recon, speech_perp, rir_perp = out[:3]
        recon_error = torch.mean((recon[..., : x.shape[-1]] - x) ** 2)
        return recon_error, {"recon_error": recon_error, "speech_perplexity": speech_perp, "rir_perplexity": rir_perp}

    def loss(self, model, batch, train, generator=None):
        x, x_rir = self.model_inputs(batch)
        out = model(
            x, x_rir, train=train, train_encoder=self.train_encoder,
            return_vq_losses=bool(self.commitment_weight), generator=generator,
        )
        # recon only (train_echoed_speech.py:89); the codebooks stay frozen
        loss, metrics = self._recon_loss(out, x)
        if self.commitment_weight:
            loss = loss + self.commitment_weight * (out[3]["speech"] + out[3]["rir"])
        return loss, metrics

    # ----- frozen-latent cache: with both branches frozen, their codes are
    # constant per sample, so the trainer computes them once per dataset and
    # the step runs the decoder alone (train_echoed_speech.py re-runs both
    # encoder stacks every step) -----

    @property
    def supports_cache(self) -> bool:
        # not with train_encoder (the codes move every step) nor with an
        # anchor (the branch VQ losses enter the loss)
        return not self.train_encoder and not self.commitment_weight

    @property
    def cached_frozen_subtrees(self) -> Tuple[str, ...]:
        """The submodules whose weights the cache assumes constant."""
        return ("rir_model", "speech_model")

    def build_cache(self, model: EchoedSpeechReconModel, batch: SampleBatch) -> Dict[str, torch.Tensor]:
        """The frozen branches' code ids of every sample of ``batch``."""
        return model.encode_codes(*self.model_inputs(batch))

    def loss_cached(self, model, batch, cache, train, generator=None):
        """:meth:`loss` from cached codes: the decoder alone, the same
        latents, jitter decisions and metrics, up to the last bit of the
        straight-through value."""
        x, _ = self.model_inputs(batch)
        out = model.decode_from_codes(cache["speech_codes"], cache["rir_codes"], train=train, generator=generator)
        return self._recon_loss(out, x)


@dataclasses.dataclass(frozen=True)
class EncoderFinetuneTask(EchoedSpeechTask):
    """The encoders unfrozen at lr 1e-5, the codebooks still frozen
    (encoder_training_echoed_model.py)."""

    name: str = "finetune"
    learning_rate: float = 1e-5
    num_updates: int = 5000
    train_encoder: bool = True


def _transposed_input(echoed_spec: torch.Tensor) -> torch.Tensor:
    # z-norm over frequency THEN permute (B, F, T) -> (B, T, F) (train_location.py:63-66)
    return znorm(echoed_spec, dim=1).transpose(1, 2)


def _angle_target(theta: torch.Tensor, target_mode: str) -> torch.Tensor:
    """(B, 1) theta/pi (train_location.py:77-78), or (B, 2) (sin, cos)."""
    if target_mode == "sincos":
        return torch.cat([torch.sin(theta), torch.cos(theta)], dim=1)
    return theta / math.pi


@dataclasses.dataclass(frozen=True)
class LocationTask(Task):
    """Angle regression from the frozen composite's RIR-branch features
    (train_location.py); B = 16, lr 1e-3."""

    name: str = "location"
    learning_rate: float = 1e-3
    batch_size: int = 16
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    compute_dtype: str = "float32"  # the frozen RIR branch's; the head stays float32
    output_dim: int = 1
    # "encodings": flattened one-hot code assignments (the reference input);
    # "quantized": the RIR-branch quantized latents
    input_mode: str = "encodings"
    # "normalized_angle": theta/pi (the reference target); "sincos": atan2
    target_mode: str = "normalized_angle"
    # None resolves like the JAX composite builder: the compat flatten
    compat_vq_flatten: Optional[bool] = None

    @property
    def feature_width(self) -> int:
        """The width of a feature row: the RIR branch's D for quantized
        latents, its K for one-hot encodings."""
        return _scale(64 if self.input_mode == "quantized" else 1024, self.width_scale)

    def build_model(self, generator: Optional[torch.Generator] = None) -> LocationModule:
        out_dim = 2 if self.target_mode == "sincos" else self.output_dim
        return LocationModule(self.config.num_freq, self.feature_width, out_dim, generator)

    def build_composite(self, generator: Optional[torch.Generator] = None) -> EchoedSpeechReconModel:
        """The composite whose RIR branch feeds the head (train_location.py:38)."""
        return _echoed_model(self.config, self.width_scale, resolved_vq_flatten(self), generator, self.compute_dtype)

    def build_rir_model(self, generator: Optional[torch.Generator] = None) -> ConvolutionalVQVAE:
        """The composite's RIR branch without its decoder: all the frozen
        localizer runs."""
        return rir_model(self.config, self.width_scale, resolved_vq_flatten(self), generator,
                         compute_dtype=self.compute_dtype)

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

    # ----- frozen-latent cache: the whole composite is frozen here
    # (train_location.py:69), so the RIR branch's codes are constant per
    # sample and the step reduces to the MLP -----

    @property
    def supports_cache(self) -> bool:
        return True

    def build_cache(self, rir: ConvolutionalVQVAE, batch: SampleBatch) -> Dict[str, torch.Tensor]:
        return {"rir_codes": rir.get_latent_codes(_transposed_input(batch.echoed_spec))}

    def feats_from_codes(self, rir: ConvolutionalVQVAE, cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """:meth:`encodings_from_composite` from cached codes: the one-hot of
        the same ids, or the codebook rows of the same ids."""
        codes = cache["rir_codes"]  # (B, F)
        if self.input_mode == "quantized":
            feats = rir.codes_to_latent(codes).transpose(1, 2)  # (B, F, D)
        else:
            feats = F.one_hot(codes.long(), rir.num_embeddings).to(rir._vq._embedding.weight.dtype)  # (B, F, K)
        return feats.detach()

    # ----- the frozen path: the composite's RIR branch, held by the trainer
    # outside the model and the optimizer -----

    def build_frozen(self, composite_params: Optional[StateDict], device: torch.device) -> ConvolutionalVQVAE:
        """The composite's RIR branch without its never-run decoder, from the
        ``rir_model.*`` entries of ``composite_params`` (copies; every key of
        the branch required), on ``device``, in eval mode and without
        gradients: the reference reads only ``composite_params["rir_model"]``
        (train_location.py:38,69)."""
        if composite_params is None:
            raise ValueError("LocationTask requires composite_params")
        with torch.device("meta"):  # no weights are drawn only to be overwritten
            rir = self.build_rir_model()
        prefix = "rir_model."
        rir.load_state_dict(
            {k[len(prefix):]: torch.as_tensor(v).to(device, torch.float32, copy=True)
             for k, v in composite_params.items() if k.startswith(prefix) and not k.startswith(prefix + "_decoder.")},
            assign=True,
        )
        return rir.eval().requires_grad_(False)

    def frozen_features(
        self, rir: ConvolutionalVQVAE, batch: SampleBatch, cache: Optional[Dict[str, torch.Tensor]] = None
    ) -> torch.Tensor:
        """The head's input: the frozen RIR branch's features of ``batch``,
        from its cache rows where given."""
        with torch.no_grad():
            if cache is not None:
                return self.feats_from_codes(rir, cache)
            return self.encodings_from_composite(rir, batch.echoed_spec)

    def step_loss(self, model, frozen, batch, train, generator=None, cache=None):
        return self.loss(model, batch, train, generator, feats=self.frozen_features(frozen, batch, cache))

    def step_cache(self, model, frozen, batch):
        return self.build_cache(frozen, batch)

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        return ("echoed_spec", "fs", "theta")

    def loss(self, model, batch, train, generator=None, feats: Optional[torch.Tensor] = None):
        """MSE of the head's prediction on ``feats``, the composite's
        features of ``batch`` (train_location.py:77-78)."""
        if feats is None:
            raise ValueError("LocationTask.loss needs the composite's features (feats=)")
        pred = model(feats)
        target = _angle_target(batch.theta.reshape(-1, 1).to(pred.dtype), self.target_mode)
        loss = torch.mean((pred - target) ** 2)
        return loss, {"location_error": loss}

    def decode_angle(self, pred: torch.Tensor) -> torch.Tensor:
        """Model output -> angle in radians."""
        if self.target_mode == "sincos":
            return torch.atan2(pred[:, 0], pred[:, 1])
        return pred.reshape(-1) * math.pi


@dataclasses.dataclass(frozen=True)
class JointLocationTask(Task):
    """RIR encoder + location head fine-tuned together on the angle loss,
    the codebook frozen (``location_joint``, beyond the reference, whose
    train_location.py:69 freezes the composite); the deployed localizer.
    Gradients reach the encoder through the straight-through estimator; the
    commitment term of the frozen-codebook VQ loss anchors it."""

    name: str = "location_joint"
    learning_rate: float = 1e-4
    batch_size: int = 16
    num_updates: int = 15000
    config: DatasetConfig = DatasetConfig()
    width_scale: float = 1.0
    compute_dtype: str = "float32"  # the RIR encoder's; the head stays float32
    compat_vq_flatten: bool = False  # one-hot-free gradients need vectors
    target_mode: str = "sincos"
    output_dim: int = 1
    commitment_weight: float = 0.25
    # trailing head column: the source radius in meters, trained on
    # batch.radius with radius_weight
    predict_radius: bool = False
    radius_weight: float = 1.0
    # hard-example term: tail_weight x the mean of the worst
    # ceil(tail_frac x B) per-sample angle errors; 0 leaves it out
    tail_weight: float = 0.0
    tail_frac: float = 0.125
    # present for symmetry but refused: the model is the RIR branch and the head, whose conv length is the
    # short frequency axis (the spectrogram's time enters as channels)
    sequence_axis: Optional[str] = None

    def build_model(self, generator: Optional[torch.Generator] = None) -> JointLocationModel:
        if self.sequence_axis is not None:
            raise ValueError("JointLocationTask does not support sequence parallelism: its compute is the rir branch "
                             "(time-as-channels, conv length = the short freq axis); use sequence parallelism on "
                             "the speech/echoed/finetune stages")
        rir = rir_model(self.config, self.width_scale, self.compat_vq_flatten, generator,
                        compute_dtype=self.compute_dtype)
        out_dim = 2 if self.target_mode == "sincos" else self.output_dim
        if self.predict_radius:
            out_dim += 1
        return JointLocationModel(rir, self.config.num_freq, out_dim, generator)

    @staticmethod
    def seed_params(fresh: StateDict, composite: StateDict) -> Dict[str, torch.Tensor]:
        """The joint model's state dict with its RIR branch taken from a
        composite's (``rir_model.*``, copies): the joint stage's handoff. The
        branch's decoder, which the joint model lacks, is not read."""
        return {k: (composite[k].detach().clone() if k.startswith("rir_model.") else v) for k, v in fresh.items()}

    @property
    def resident_fields(self) -> Tuple[str, ...]:
        return ("echoed_spec", "fs", "theta", "radius")

    def model_inputs(self, echoed_spec: torch.Tensor) -> Tuple[torch.Tensor]:
        return (_transposed_input(echoed_spec),)

    def loss(self, model, batch, train, generator=None):
        (x_trans,) = self.model_inputs(batch.echoed_spec)
        pred, perp, vq_loss = model(x_trans)
        target = _angle_target(batch.theta.reshape(-1, 1).to(pred.dtype), self.target_mode)
        pred_loc = pred[:, :-1] if self.predict_radius else pred
        per_sample = torch.mean((pred_loc - target) ** 2, dim=1)  # (B,)
        mse = torch.mean(per_sample)
        loss = mse + self.commitment_weight * vq_loss
        metrics = {"location_error": mse, "rir_perplexity": perp}
        if self.tail_weight:
            k = max(1, math.ceil(per_sample.shape[0] * self.tail_frac))
            tail = torch.mean(torch.topk(per_sample, k).values)
            loss = loss + self.tail_weight * tail
            metrics["tail_error"] = tail
        if self.predict_radius:
            mse_r = torch.mean((pred[:, -1] - batch.radius.to(pred.dtype)) ** 2)  # meters
            loss = loss + self.radius_weight * mse_r
            metrics["radius_error"] = mse_r
        return loss, metrics

    def decode_angle(self, pred: torch.Tensor) -> torch.Tensor:
        if self.target_mode == "sincos":
            return torch.atan2(pred[:, 0], pred[:, 1])
        return pred[:, 0] * math.pi

    def decode_radius(self, pred: torch.Tensor) -> torch.Tensor:
        """Predicted source radius in meters (the trailing head column)."""
        if not self.predict_radius:
            raise ValueError("decode_radius requires predict_radius=True")
        return pred[:, -1]


def graft_pretrained(
    composite: StateDict, speech: Optional[StateDict] = None, rir: Optional[StateDict] = None
) -> Dict[str, torch.Tensor]:
    """The stage handoff: a composite's state dict with the speech and RIR
    stages' state dicts put under ``speech_model.`` and ``rir_model.``, as
    copies (the reference loads the pickled modules whole,
    train_echoed_speech.py:18-19).

    A donor trained with an EMA codebook carries its codebook as the
    ``_vq._embedding.weight`` buffer beside ``_vq.ema_counts`` and
    ``_vq.ema_sums``: the codebook becomes the composite's frozen parameter
    and the EMA statistics are dropped (the JAX ``graft_codebook``)."""
    out = dict(composite)
    for prefix, donor in (("speech_model.", speech), ("rir_model.", rir)):
        if donor is None:
            continue
        out = {k: v for k, v in out.items() if not k.startswith(prefix)}
        for k, v in donor.items():
            if k not in ("_vq.ema_counts", "_vq.ema_sums"):
                out[prefix + k] = v.detach().clone()
    return out


def resolved_vq_flatten(task) -> bool:
    """The task's VQ flatten as a bool, True being the reference's
    memory-order flatten (vector_quantizer.py:32); ``None`` resolves to it,
    or to the vectors flatten where the task shards its time axis
    (``sequence_axis``), as the JAX tasks' build_model does."""
    v = getattr(task, "compat_vq_flatten", None)
    return getattr(task, "sequence_axis", None) is None if v is None else bool(v)


def check_flatten_handoff(donor_meta: dict, task, donor_label: str) -> None:
    """Refuse a stage handoff across VQ flatten modes.

    The two modes give the same parameter shapes but codes of another
    meaning (memory-order time chunks against channel vectors), so a
    codebook grafted across them loads and then trains on garbage latents.
    ``donor_meta`` is the donor stage's metadata; one without a
    ``compat_vq_flatten`` entry is not checked."""
    if "compat_vq_flatten" not in donor_meta:
        return
    donor = bool(donor_meta["compat_vq_flatten"])
    mine = resolved_vq_flatten(task)
    if donor != mine:
        names = {True: "compat", False: "vectors"}
        raise ValueError(
            f"VQ flatten mismatch: stage {donor_label!r} was trained with the "
            f"{names[donor]!r} flatten but task {task.name!r} resolves to "
            f"{names[mine]!r}. The codebooks are shape-compatible but their "
            "codes mean different things, so the handoff would silently "
            f"corrupt training. Build this task with compat_vq_flatten={donor} "
            f"(or retrain the donor with compat_vq_flatten={mine})."
        )


@dataclasses.dataclass(frozen=True)
class CodecTask(Task):
    """EnCodec (``models/encodec.py``), serving only: the fields are the
    published 24 kHz configuration's keys and defaults
    (``facebook/encodec_24khz``), ``bandwidth`` the served kbps (24: all 32
    stages). ``width_scale`` scales ``num_filters`` and ``codebook_size`` as
    the other tasks scale their widths, for runs at reduced width; 1 is the
    published model. The codebook dim ``hidden_size`` is not scaled: the
    residual chain at a few dims shrinks its residual below float32's
    rounding of the latent within a dozen stages. Training it needs
    EnCodec's discriminators and loss balancer, which are not ported:
    :meth:`loss` raises."""

    name: str = "codec"
    learning_rate: float = 0.0
    batch_size: int = 32
    num_updates: int = 0
    width_scale: float = 1.0
    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    compress: int = 2
    num_lstm_layers: int = 2
    codebook_size: int = 1024
    target_bandwidths: Tuple[float, ...] = (1.5, 3.0, 6.0, 12.0, 24.0)
    bandwidth: float = 24.0

    def build_model(self, generator: Optional[torch.Generator] = None) -> EncodecModel:
        ws = self.width_scale
        return EncodecModel(
            sampling_rate=self.sampling_rate, audio_channels=self.audio_channels,
            num_filters=_scale(self.num_filters, ws), hidden_size=self.hidden_size,
            upsampling_ratios=tuple(self.upsampling_ratios), kernel_size=self.kernel_size,
            last_kernel_size=self.last_kernel_size, residual_kernel_size=self.residual_kernel_size,
            num_residual_layers=self.num_residual_layers, dilation_growth_rate=self.dilation_growth_rate,
            compress=self.compress, num_lstm_layers=self.num_lstm_layers,
            codebook_size=_scale(self.codebook_size, ws), target_bandwidths=tuple(self.target_bandwidths))

    def model_inputs(self, batch: SampleBatch) -> Tuple:
        raise NotImplementedError("the codec is served on waveforms (eval/serving.py:make_codec_serving_fn)")

    def loss(self, model, batch, train, generator=None):
        raise NotImplementedError("training EnCodec needs its discriminators and loss balancer, which are not ported")


_TASKS = {
    "speech": SpeechVQVAETask,
    "rir": RirVQVAETask,
    "echoed": EchoedSpeechTask,
    "finetune": EncoderFinetuneTask,
    "location": LocationTask,
    "location_joint": JointLocationTask,
    "codec": CodecTask,
}


def make_task(name: str, **kwargs) -> Task:
    """The stage task of ``name`` (one of ``_TASKS``), with ``kwargs`` as fields."""
    return _TASKS[name](**kwargs)
