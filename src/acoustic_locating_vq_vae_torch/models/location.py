"""Location regression MLP and the joint localizer.

Counterpart of ``acoustic_locating_vq_vae_tpu/models/location.py`` (reference:
vq_vae/location_model/location_model.py:5-29).

On a model axis (``parallel.shard_model``) the partition rules split each
large ``Dense`` by its larger dimension (JAX ``sharding_rules.py:47-52``): the
frozen localizer's fc_1 (205,824 x 1,024, 843 MB) by its input features, so a
rank holds its block of the weight and of Adam's moments and the partial
outputs are summed over the group (``ops/conv.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Dense
from .conv_vqvae import ConvolutionalVQVAE

__all__ = ["LocationModule", "JointLocationModel"]


class LocationModule(nn.Module):
    """Row-major flatten of ``(B, encoder_output_dim, num_hiddens)`` features,
    then fc widths in -> 1024 -> 512 -> 512 -> 64 -> ``output_dim``."""

    def __init__(
        self,
        encoder_output_dim: int,
        num_hiddens: int,
        output_dim: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.fc_1 = Dense(encoder_output_dim * num_hiddens, 1024, generator)
        self.fc_2 = Dense(1024, 512, generator)
        self.fc_3 = Dense(512, 512, generator)
        self.fc_4 = Dense(512, 64, generator)
        self.fc_5 = Dense(64, output_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.flatten(x, start_dim=1)
        z = F.relu(self.fc_1(z))
        z = F.relu(self.fc_2(z))
        z = F.relu(self.fc_3(z))
        z = F.relu(self.fc_4(z))
        return self.fc_5(z)


class JointLocationModel(nn.Module):
    """RIR encoder + location head over the dense quantized latent, the
    codebook frozen. ``encoder_output_dim`` is the latent length L (the 201
    frequency bins of the transposed spectrogram)."""

    def __init__(
        self,
        rir_model: ConvolutionalVQVAE,
        encoder_output_dim: int,
        output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.rir_model = rir_model
        self.head = LocationModule(encoder_output_dim, rir_model.embedding_dim, output_dim, generator)

    def forward(self, x_trans: torch.Tensor):
        """``x_trans``: the transposed echoed spectrogram (B, T, F). Returns
        (prediction, rir_perplexity, rir_vq_loss)."""
        vq_loss, q, perp, _ = self.rir_model.get_latent_representation(x_trans, need_encodings=False)
        pred = self.head(q.transpose(1, 2))  # (B, F, D_rir)
        return pred, perp, vq_loss
