"""NN building blocks: conv, transposed conv and dense layers, residual
stacks, latent jitter, the vector quantizer and its CUDA kernels."""

from .conv import Conv1d, ConvTranspose1d, Dense
from .jitter import Jitter, jitter, jitter_decisions
from .residual import Residual, ResidualStack
from .vq import (
    VectorQuantizer,
    VQOutput,
    assign,
    codebook_grad,
    codebook_grad_plain,
    codebook_stats,
    codebook_stats_plain,
    nearest_codebook,
    nearest_indices,
)
from .vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda

__all__ = [
    "Conv1d",
    "ConvTranspose1d",
    "Dense",
    "Jitter",
    "jitter",
    "jitter_decisions",
    "Residual",
    "ResidualStack",
    "VectorQuantizer",
    "VQOutput",
    "assign",
    "codebook_grad",
    "codebook_grad_plain",
    "codebook_stats",
    "codebook_stats_plain",
    "nearest_codebook",
    "nearest_indices",
    "codebook_grad_cuda",
    "codebook_stats_cuda",
    "nearest_indices_cuda",
]
