"""acoustic_locating_vq_vae_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``acoustic_locating_vq_vae_tpu``,
ported slice by slice with the same module paths. It imports ``torch`` and
never ``jax`` nor the JAX package. The TPU's Pallas kernels become kernels
written by hand for Hopper (``csrc/``, built with ``nvcc`` for ``sm_90a`` at
first use).

This slice holds the localizers' serving path: the joint localizer and the
frozen localizer, from an echoed power spectrogram to (angle, radius,
coordinates), with the nearest-codebook assignment as a CUDA kernel.

Subpackages
-----------
data    dataset geometry (DatasetConfig)
dsp     znorm, source_coordinates
ops     Conv1d, Dense, residual stacks, vector quantizer, the CUDA kernel's wrapper and build
models  ConvolutionalVQVAE (encode half), LocationModule, JointLocationModel
train   LocationTask, JointLocationTask (inference part)
eval    weights from the JAX package's parameter trees, the serving closure
"""

__version__ = "0.1.0"

from . import data, dsp, eval, models, ops, train

__all__ = ["data", "dsp", "eval", "models", "ops", "train", "__version__"]
