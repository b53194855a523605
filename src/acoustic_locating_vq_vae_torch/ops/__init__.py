"""NN building blocks: conv, transposed conv and dense layers, residual
stacks, latent jitter, the vector quantizer and its CUDA kernels, the
residual quantizer, and the wrapper of the image-source tap kernel."""

from .conv import Conv1d, ConvTranspose1d, Dense
from .jitter import Jitter, jitter, jitter_decisions, jitter_sharded
from .residual import Residual, ResidualStack
from .rir_cuda import rir_taps_cuda
from .vq import (
    VQ_NEAREST_OP,
    VQ_NEAREST_SCORED_OP,
    VectorQuantizer,
    VQOutput,
    ResidualVectorQuantizer,
    assign,
    codebook_grad,
    codebook_grad_plain,
    codebook_stats,
    codebook_stats_plain,
    merge_nearest,
    nearest_codebook,
    nearest_indices,
    nearest_scored,
    residual_codes,
    vq_nearest,
    vq_nearest_scored,
)
from .vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda

__all__ = [
    "Conv1d",
    "ConvTranspose1d",
    "Dense",
    "Jitter",
    "jitter",
    "jitter_decisions",
    "jitter_sharded",
    "Residual",
    "ResidualStack",
    "VectorQuantizer",
    "VQOutput",
    "ResidualVectorQuantizer",
    "residual_codes",
    "VQ_NEAREST_OP",
    "VQ_NEAREST_SCORED_OP",
    "vq_nearest",
    "vq_nearest_scored",
    "merge_nearest",
    "nearest_scored",
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
    "rir_taps_cuda",
]
