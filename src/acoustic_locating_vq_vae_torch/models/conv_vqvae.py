"""ConvolutionalVQVAE and its encoder and decoder halves.

Counterpart of ``acoustic_locating_vq_vae_tpu/models/conv_vqvae.py`` (reference:
vq_vae/convolutional_vq_vae.py:18-105, convolutional_encoder.py:7-44,
deconvolutional_decoder.py:7-79).

``sequence_axis`` (JAX ``:41-105, 157-170``) names the mesh axis that shards
the time axis: every 3-tap conv and transposed conv exchanges halos, the
jitter reads its window of the global decisions, the quantizer sums its code
counts and EMA statistics over the axis, and a mean over time is the mean
over the shards. It needs the vectors VQ flatten (``compat_vq_flatten=False``):
the reference's memory-order flatten makes each quantized row D consecutive
time frames, which cross the shards. The mesh comes from
:func:`sequence_sharding` while a sharded step runs; without one the model is
the plain model, parameter for parameter.

``compute_dtype`` (None for float32, or ``torch.bfloat16``; JAX ``:144, 178,
182, 205``) is the conv stacks' compute dtype: every conv computes in it (see
``ops/conv.py``), the ReLUs and skips run in it, and the parameters stay
float32. The pre-VQ latent is cast to the codebook's float32 before the
quantizer (JAX ``:231, 237``), so the assignment is exact float32 and the VQ
loss is float32; the decoder reads that float32 latent and its output is cast
to its parameters' float32 (JAX ``:110``), so losses are float32. (A model
moved to float64 as a reference computes in float64 throughout.)

Layout is channels-first ``(B, C, L)`` throughout, the public layout of both
packages; module attributes carry the reference's state-dict keys
(``_encoder._conv_1.weight``, ``_pre_vq_conv.weight``,
``_vq._embedding.weight``, ``_decoder._conv_trans_1.weight``, ...).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv1d, ConvTranspose1d
from ..ops.jitter import Jitter
from ..ops.residual import ResidualStack
from ..ops.vq import VectorQuantizer, VQOutput

__all__ = ["ConvolutionalEncoder", "DeconvolutionalDecoder", "ConvolutionalVQVAE", "sequence_sharding"]


@contextlib.contextmanager
def sequence_sharding(module: nn.Module, mesh):
    """While open, every submodule of ``module`` built with a
    ``sequence_axis`` runs on that axis of ``mesh`` (its ``mesh``); the
    previous meshes come back on exit."""
    mods = [m for m in module.modules() if getattr(m, "sequence_axis", None) is not None]
    saved = [m.mesh for m in mods]
    for m in mods:
        m.mesh = mesh
    try:
        yield
    finally:
        for m, g in zip(mods, saved):
            m.mesh = g


class ConvolutionalEncoder(nn.Module):
    """Conv3 -> ResidualStack with an extra outer skip
    (convolutional_encoder.py:39-44): ``(B, C_in, L) -> (B, H, L)``."""

    def __init__(
        self,
        in_channels: int,
        num_hiddens: int,
        num_residual_layers: int,
        num_residual_hiddens: int,
        tied: bool = True,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        # the reference quirk needs a first block to have mutated x1 in place
        self.skip_relu = compat_inplace_relu and num_residual_layers > 0
        self._conv_1 = Conv1d(in_channels, num_hiddens, 3, padding=1, generator=generator, compute_dtype=compute_dtype,
                              sequence_axis=sequence_axis)
        self._residual_stack = ResidualStack(
            num_hiddens, num_residual_layers, num_residual_hiddens, tied=tied,
            compat_init=compat_init, compat_inplace_relu=compat_inplace_relu, generator=generator,
            compute_dtype=compute_dtype, sequence_axis=sequence_axis,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self._conv_1(x)
        out = self._residual_stack(x1)
        # Reference quirk (ops/residual.py): the first block's in-place ReLU
        # mutated x1, so the outer skip adds relu(x1).
        return out + (F.relu(x1) if self.skip_relu else x1)


class DeconvolutionalDecoder(nn.Module):
    """[Jitter] -> Conv3 -> ResidualStack -> 2 x (ConvT3 + ReLU) -> ConvT3
    (deconvolutional_decoder.py:62-79): ``(B, D, L) -> (B, C_out, L)``, the
    output float32 whatever ``compute_dtype``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_hiddens: int,
        num_residual_layers: int,
        num_residual_hiddens: int,
        use_jitter: bool = True,
        jitter_probability: float = 0.25,
        tied: bool = True,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype, sequence_axis=sequence_axis)
        self._jitter = Jitter(jitter_probability, sequence_axis=sequence_axis) if use_jitter else None
        self._conv_1 = Conv1d(in_channels, num_hiddens, 3, padding=1, generator=generator, **dt)
        self._residual_stack = ResidualStack(
            num_hiddens, num_residual_layers, num_residual_hiddens, tied=tied,
            compat_init=compat_init, compat_inplace_relu=compat_inplace_relu, generator=generator, **dt,
        )
        self._conv_trans_1 = ConvTranspose1d(num_hiddens, num_hiddens, generator=generator, **dt)
        self._conv_trans_2 = ConvTranspose1d(num_hiddens, num_hiddens, generator=generator, **dt)
        self._conv_trans_3 = ConvTranspose1d(num_hiddens, out_channels, generator=generator, **dt)

    def forward(
        self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if self._jitter is not None:
            x = self._jitter(x, train=train, generator=generator)
        x = self._residual_stack(self._conv_1(x))
        x = F.relu(self._conv_trans_1(x))
        x = F.relu(self._conv_trans_2(x))
        out = self._conv_trans_3(x)
        return out.to(self._conv_trans_3.weight.dtype)  # the parameters' float32: losses accumulate in it


class ConvolutionalVQVAE(nn.Module):
    """Encoder -> pre-VQ conv -> [mean-pool] -> VQ -> decoder
    (convolutional_vq_vae.py:93-100).

    ``compat_vq_flatten=True`` is the reference's memory-order flatten
    (vector_quantizer.py:32): the quantizer reshapes the channels-first
    ``(B, D, L)`` latent to ``(-1, D)`` without permuting, so each row is D
    consecutive samples along time. ``False`` quantizes proper channel vectors
    (the latent permuted to ``(B, L, D)`` first). Both give B*L rows.
    ``sequence_axis`` shards the time axis (see the module docstring) and
    raises with the memory-order flatten.

    ``decoder=False`` builds the encode half only (the localizers' RIR
    branch). ``compute_dtype`` goes to the encoder, the pre-VQ conv and the
    decoder (see the module docstring)."""

    def __init__(
        self,
        in_channels: int,
        num_hiddens: int,
        embedding_dim: int,
        num_residual_layers: int,
        num_residual_hiddens: int,
        commitment_cost: float,
        num_embeddings: int,
        tied: bool = True,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        compat_vq_flatten: bool = True,
        use_jitter: bool = True,
        jitter_probability: float = 0.25,
        out_channels: Optional[int] = None,
        encoder_average_pooling: bool = False,
        vq_ema: bool = False,
        vq_ema_decay: float = 0.99,
        vq_ema_reset: float = 0.0,
        decoder: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        if sequence_axis is not None and compat_vq_flatten:
            raise ValueError(
                "sequence_axis requires compat_vq_flatten=False: the reference's memory-order VQ flatten chunks "
                "across time positions and cannot be computed with the time axis sharded")
        dt = dict(compute_dtype=compute_dtype, sequence_axis=sequence_axis)
        self.sequence_axis = sequence_axis
        self.mesh = None
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.compat_vq_flatten = compat_vq_flatten
        self.encoder_average_pooling = encoder_average_pooling
        self._encoder = ConvolutionalEncoder(
            in_channels, num_hiddens, num_residual_layers, num_residual_hiddens, tied=tied,
            compat_init=compat_init, compat_inplace_relu=compat_inplace_relu, generator=generator, **dt,
        )
        self._pre_vq_conv = Conv1d(num_hiddens, embedding_dim, 3, padding=1, generator=generator, **dt)
        self._vq = VectorQuantizer(
            num_embeddings, embedding_dim, commitment_cost, generator=generator,
            ema=vq_ema, ema_decay=vq_ema_decay, ema_reset_threshold=vq_ema_reset, sequence_axis=sequence_axis,
        )
        # The localizers run only the encode half: their RIR branch has no
        # decoder, as flax creates no parameters for an uncalled submodule.
        self._decoder = None if not decoder else DeconvolutionalDecoder(
            embedding_dim, out_channels if out_channels is not None else in_channels, num_hiddens,
            num_residual_layers, num_residual_hiddens, use_jitter=use_jitter,
            jitter_probability=jitter_probability, tied=tied, compat_init=compat_init,
            compat_inplace_relu=compat_inplace_relu, generator=generator, **dt,
        )

    def pre_vq_latent(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C, L) -> (B, D, L)``: the latent the quantizer reads, in the
        codebook's dtype (float32)."""
        return self._pre_vq_conv(self._encoder(x)).to(self._vq._embedding.weight.dtype)

    def _encode(self, x: torch.Tensor, train_vq: bool, need_encodings: bool = False) -> VQOutput:
        """VQ output whose ``quantized`` is channels-first ``(B, D, L)``."""
        z = self._pre_vq_conv(self._encoder(x))
        if self.encoder_average_pooling:
            z = torch.mean(z, dim=2, keepdim=True)  # over time (convolutional_vq_vae.py:96-97)
            if self.sequence_axis is not None and self.mesh is not None:
                from ..parallel.sequence import seq_pmean

                z = seq_pmean(z, self.mesh, self.sequence_axis)
        z = z.to(self._vq._embedding.weight.dtype)  # the assignment in float32 whatever the compute dtype
        if self.compat_vq_flatten:
            # the quantizer's reshape(-1, D) of the contiguous (B, D, L) latent
            # is the reference's view(-1, D)
            return self._vq(z.contiguous(), train_vq=train_vq, need_encodings=need_encodings)
        out = self._vq(z.transpose(1, 2), train_vq=train_vq, need_encodings=need_encodings)
        return out._replace(quantized=out.quantized.transpose(1, 2))

    def forward(
        self, x: torch.Tensor, train: bool = True, train_vq: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """``(vq_loss, recon (B, C_out, L), perplexity)`` for ``x`` (B, C, L).
        ``train`` gates the decoder's jitter, whose decisions come from
        ``generator``; an EMA codebook updates when ``train_vq`` is true and
        the module is in training mode."""
        out = self._encode(x, train_vq)
        recon = self._decoder(out.quantized, train=train, generator=generator)
        return out.loss, recon, out.perplexity

    def get_latent_representation(self, x: torch.Tensor, need_encodings: bool = True):
        """(loss, quantized (B, D, L), perplexity, encodings (B*L, K) or None),
        the reference return layout (convolutional_vq_vae.py:102-105), with
        the codebook frozen."""
        out = self._encode(x, train_vq=False, need_encodings=need_encodings)
        return out.loss, out.quantized, out.perplexity, out.encodings

    def get_latent_codes(self, x: torch.Tensor) -> torch.Tensor:
        """VQ code ids, ``(B, rows_per_sample)``, with the codebook frozen."""
        return self._encode(x, train_vq=False).indices.reshape(x.shape[0], -1)

    def codes_to_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`get_latent_codes`: ``(B, R)`` ids -> quantized
        latent ``(B, D, L)`` in the model's flatten mode."""
        b, r = codes.shape
        q = self._vq.lookup(codes).reshape(b, r * self.embedding_dim)
        if self.compat_vq_flatten:
            return q.reshape(b, self.embedding_dim, r)
        return q.reshape(b, r, self.embedding_dim).transpose(1, 2)
