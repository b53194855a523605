"""NN building blocks: conv and dense layers, residual stacks, the vector
quantizer and its CUDA nearest-codebook kernel."""

from .conv import Conv1d, Dense
from .residual import Residual, ResidualStack
from .vq import VectorQuantizer, VQOutput, assign, nearest_codebook, nearest_indices
from .vq_cuda import nearest_indices_cuda

__all__ = [
    "Conv1d",
    "Dense",
    "Residual",
    "ResidualStack",
    "VectorQuantizer",
    "VQOutput",
    "assign",
    "nearest_codebook",
    "nearest_indices",
    "nearest_indices_cuda",
]
