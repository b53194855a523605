"""Vector quantizer (reference: vq_vae/vector_quantizer.py:8-58), inference half.

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/vq.py`` at ``train_vq=False``
(frozen codebook): the assignment, the loss value ``q_latent + beta *
e_latent``, the straight-through output, the batch perplexity, the code ids,
the optional one-hot encodings and ``lookup``. The EMA codebook and the
training paths come with the training slice.

Where the assignment runs follows the tensor alone: a CUDA tensor goes to the
hand-written kernel (``ops/vq_cuda.py``, ``csrc/vq_nearest.cu``), a CPU tensor
to the plain version :func:`nearest_indices`. There is no fallback between
them and no switch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import uniform_
from .vq_cuda import nearest_indices_cuda

__all__ = ["VectorQuantizer", "VQOutput", "nearest_indices", "nearest_codebook", "assign", "perplexity_from_indices"]


def nearest_indices(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``argmin_k (e2[k] - 2 x . e_k)`` per row,
    the Pallas kernel's score (``||x||^2`` is row-constant and left out).
    ``torch.argmin`` returns the first minimal index, as the kernel does."""
    return torch.argmin(e2 - 2.0 * (flat_x @ codebook.T), dim=1)


def nearest_codebook(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain nearest-neighbour assignment: (N, D) x (K, D) -> (indices (N,)
    int64, quantized (N, D))."""
    e2 = torch.sum(codebook * codebook, dim=1)
    indices = nearest_indices(flat_x, codebook, e2)
    return indices, codebook.index_select(0, indices)


def assign(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nearest_codebook` for a CPU tensor, the CUDA kernel for a CUDA
    tensor; raises for any other device."""
    if flat_x.device.type == "cpu":
        return nearest_codebook(flat_x, codebook)
    if flat_x.device.type != "cuda":
        raise ValueError(f"no nearest-codebook assignment for device {flat_x.device}")
    x = flat_x.contiguous()
    cb = codebook.contiguous()
    e2 = torch.sum(cb * cb, dim=1)
    indices = nearest_indices_cuda(x, cb, e2).long()
    return indices, cb.index_select(0, indices)


def perplexity_from_indices(indices: torch.Tensor, num_embeddings: int) -> torch.Tensor:
    """exp(entropy of code usage) over the given assignments
    (vector_quantizer.py:55-56)."""
    flat = indices.reshape(-1)
    counts = torch.bincount(flat, minlength=num_embeddings).to(torch.float32)
    avg_probs = counts / flat.shape[0]
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))


class VQOutput(NamedTuple):
    loss: torch.Tensor
    quantized: torch.Tensor  # straight-through, input shape
    perplexity: torch.Tensor
    indices: torch.Tensor  # (N,) code ids
    encodings: Optional[torch.Tensor] = None  # (N, K) one-hot, on request


class VectorQuantizer(nn.Module):
    """Frozen-codebook vector quantizer. The codebook is ``_embedding.weight``
    (K, D), the reference's key, drawn U(-1/K, 1/K)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        commitment_cost: float,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        weight = uniform_(torch.empty(num_embeddings, embedding_dim), 1.0 / num_embeddings, generator)
        self._embedding = nn.Embedding(num_embeddings, embedding_dim, _weight=weight)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook rows for stored code ids (the inverse of the assignment)."""
        rows = self._embedding.weight.index_select(0, indices.reshape(-1))
        return rows.reshape(*indices.shape, self.embedding_dim)

    def forward(self, inputs: torch.Tensor, need_encodings: bool = False) -> VQOutput:
        """``inputs``: (..., D) latents, channels last. ``quantized`` has the
        input shape; ``encodings`` is None unless ``need_encodings``."""
        flat = inputs.reshape(-1, self.embedding_dim)
        indices, quantized = assign(flat, self._embedding.weight)
        e_latent_loss = torch.mean((quantized.detach() - flat) ** 2)
        # frozen codebook: same value, no gradient (vector_quantizer.py:50)
        q_latent_loss = torch.mean((quantized - flat) ** 2).detach()
        loss = q_latent_loss + self.commitment_cost * e_latent_loss

        quantized = quantized.reshape(inputs.shape)
        ste = inputs + (quantized - inputs).detach()
        perplexity = perplexity_from_indices(indices, self.num_embeddings)
        encodings = (
            F.one_hot(indices, self.num_embeddings).to(flat.dtype) if need_encodings else None
        )
        return VQOutput(loss, ste, perplexity, indices, encodings)
