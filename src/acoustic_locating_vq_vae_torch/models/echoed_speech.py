"""Echoed-speech composite model (reference: vq_vae/echoed_speech_model.py:9-56).

Counterpart of ``acoustic_locating_vq_vae_tpu/models/echoed_speech.py:34-197``.
It holds the two
pretrained VQ-VAEs (speech and RIR), concatenates their quantized latents
(the RIR latent right-padded along time to the speech latent's length) and
decodes the echoed spectrogram with a fresh decoder.

Freeze semantics, as in the reference:

* both codebooks run frozen (``get_latent_representation``,
  echoed_speech_model.py:17-18), so their q-latent losses carry no gradient;
* the concatenated latent is detached unless ``train_encoder``
  (:51-54): the finetune stage sets it, so the encoders learn through the
  straight-through estimator while the codebooks stay frozen.

The branches are full ``ConvolutionalVQVAE``s with their decoders, which the
composite never runs: the state dict of a composite grafted from the speech
and RIR stages (``train/tasks.py:graft_pretrained``) then has the keys of the
reference's module, which the JAX ``eval/torch_export.py:echoed_state_dict``
also emits (``rir_model.*``, ``speech_model.*``, ``_decoder.*``).

``compute_dtype`` is the composite decoder's (JAX ``:46, 84``); the task
builds both branches with the same one (JAX ``train/tasks.py:262-297``). The
branches hand the decoder float32 quantized latents.

``sequence_axis`` (JAX ``:19-46, 58-110``) shards the speech time axis: the
speech branch (built with the same axis) and the composite decoder run on time
shards; the RIR branch reads the whole time extent as its channels (it is fed
the transposed spectrogram), so its input is gathered over the axis, its short
latent computed on every rank, and each rank takes its window of the
zero-padded global latent (:meth:`_pad_concat_sharded`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vq import perplexity_from_indices
from ..parallel.sequence import seq_all_gather
from .conv_vqvae import ConvolutionalVQVAE, DeconvolutionalDecoder

__all__ = ["EchoedSpeechReconModel"]


class EchoedSpeechReconModel(nn.Module):
    """The speech and RIR branches, frozen, and the composite decoder over
    their concatenated latents: ``D_s + D_r`` channels in, ``out_channels``
    out (the spectrogram's frequency bins)."""

    def __init__(
        self,
        rir_model: ConvolutionalVQVAE,
        speech_model: ConvolutionalVQVAE,
        out_channels: int,
        num_hiddens: int,
        num_residual_layers: int,
        num_residual_hiddens: int,
        use_jitter: bool = True,
        jitter_probability: float = 0.25,  # echoed_speech_model.py:30
        tied: bool = True,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        if sequence_axis is not None:
            if getattr(speech_model, "sequence_axis", None) != sequence_axis:
                raise ValueError("EchoedSpeechReconModel(sequence_axis=...) requires the speech_model to be built "
                                 "with the same sequence_axis (its time axis is the sharded one)")
            if getattr(rir_model, "sequence_axis", None) is not None:
                raise ValueError("the composite's rir_model must NOT set sequence_axis: its conv length is the short "
                                 "freq axis; the composite gathers its input and runs it replicated per shard")
        self.sequence_axis = sequence_axis
        self.mesh = None
        self.rir_model = rir_model
        self.speech_model = speech_model
        self._decoder = DeconvolutionalDecoder(
            speech_model.embedding_dim + rir_model.embedding_dim, out_channels, num_hiddens,
            num_residual_layers, num_residual_hiddens, use_jitter=use_jitter,
            jitter_probability=jitter_probability, tied=tied, compat_init=compat_init,
            compat_inplace_relu=compat_inplace_relu, generator=generator, compute_dtype=compute_dtype,
            sequence_axis=sequence_axis,
        )

    def _sharded(self) -> bool:
        return self.sequence_axis is not None and self.mesh is not None \
            and self.mesh.axis(self.sequence_axis)[2] > 1

    def forward(
        self,
        spec_in: torch.Tensor,
        spec_in_rir: torch.Tensor,
        train: bool = True,
        train_encoder: bool = False,
        return_vq_losses: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """``spec_in`` (B, F, T), ``spec_in_rir`` its transpose (B, T, F).
        Returns (recon (B, F, T), speech_perplexity, rir_perplexity) and, with
        ``return_vq_losses``, a dict of the two branch VQ losses, whose
        commitment terms carry the encoders' gradient. ``train`` gates the
        decoder's jitter, whose decisions come from ``generator``."""
        # A gradient leaves the branches only through the latent
        # (train_encoder) or the branch VQ losses; otherwise they run without
        # autograd state, as their stop-gradient'd JAX counterparts cost no
        # backward. The values are the same either way.
        sharded = self._sharded()
        with torch.set_grad_enabled(torch.is_grad_enabled() and (train_encoder or return_vq_losses)):
            if sharded:
                # the RIR branch's channels are the whole time extent: gather this rank's frames with the others'
                spec_in_rir = seq_all_gather(spec_in_rir, self.mesh, self.sequence_axis, dim=1)
            rir_loss, rir_q, rir_perp, _ = self.rir_model.get_latent_representation(spec_in_rir, need_encodings=False)
            speech_loss, speech_q, speech_perp, _ = self.speech_model.get_latent_representation(
                spec_in, need_encodings=False
            )
        quantized = self._pad_concat_sharded(speech_q, rir_q) if sharded else self._pad_concat(speech_q, rir_q)
        if not train_encoder:
            quantized = quantized.detach()  # :51-54
        out = (self._decoder(quantized, train=train, generator=generator), speech_perp, rir_perp)
        if return_vq_losses:
            return out + ({"speech": speech_loss, "rir": rir_loss},)
        return out

    @staticmethod
    def _pad_concat(speech_q: torch.Tensor, rir_q: torch.Tensor) -> torch.Tensor:
        """Right-pad the shorter latent along time and concatenate on
        channels: (B, D_s + D_r, L). The reference pads the RIR side only
        (echoed_speech_model.py:41-49); the JAX package pads either."""
        diff = speech_q.shape[2] - rir_q.shape[2]
        if diff > 0:
            rir_q = F.pad(rir_q, (0, diff))
        elif diff < 0:
            speech_q = F.pad(speech_q, (0, -diff))
        return torch.cat([speech_q, rir_q], dim=1)

    def _pad_concat_sharded(self, speech_q: torch.Tensor, rir_q: torch.Tensor) -> torch.Tensor:
        """:meth:`_pad_concat` on a time shard: ``speech_q`` is this rank's
        window (B, D_s, L_local) of the time axis, ``rir_q`` the whole
        (B, D_r, L_rir) latent; the window of the RIR latent zero-padded to the
        global length, no cross-rank traffic."""
        _, s, n = self.mesh.axis(self.sequence_axis)
        l_local = speech_q.shape[2]
        t_global = n * l_local
        if rir_q.shape[2] > t_global:
            raise ValueError(f"RIR latent length {rir_q.shape[2]} exceeds the global speech latent length "
                             f"{t_global}; the sharded composite only supports the reference geometry (rir shorter "
                             "than speech)")
        rir_pad = F.pad(rir_q, (0, t_global - rir_q.shape[2]))
        return torch.cat([speech_q, rir_pad[..., s * l_local:(s + 1) * l_local]], dim=1)

    @torch.no_grad()
    def encode_codes(self, spec_in: torch.Tensor, spec_in_rir: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The frozen branches' code ids, ``(B, rows)`` int32 each: the
        frozen-latent cache's entries, constant per sample while the encoders
        and codebooks are frozen."""
        return {
            "speech_codes": self.speech_model.get_latent_codes(spec_in),
            "rir_codes": self.rir_model.get_latent_codes(spec_in_rir),
        }

    def decode_from_codes(
        self, speech_codes: torch.Tensor, rir_codes: torch.Tensor, train: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """The decoder alone from cached code ids: ``forward`` with
        ``train_encoder=False`` (the same latents by codebook lookup, up to
        the last bit of the straight-through value ``x + (q - x)`` the
        uncached path returns; the same perplexities, from the code
        histogram; the same jitter decisions from ``generator``)."""
        with torch.no_grad():
            quantized = self._pad_concat(
                self.speech_model.codes_to_latent(speech_codes), self.rir_model.codes_to_latent(rir_codes)
            )
        recon = self._decoder(quantized, train=train, generator=generator)
        # over the global batch where the branches' quantizers reduce over a data-parallel group
        speech_perp = perplexity_from_indices(speech_codes, self.speech_model.num_embeddings,
                                              self.speech_model._vq.mesh, seq=False)
        rir_perp = perplexity_from_indices(rir_codes, self.rir_model.num_embeddings, self.rir_model._vq.mesh,
                                           seq=False)
        return recon, speech_perp, rir_perp
