"""Model layer: the VQ-VAE's encode half and the location regressors."""

from .conv_vqvae import ConvolutionalEncoder, ConvolutionalVQVAE
from .location import JointLocationModel, LocationModule

__all__ = ["ConvolutionalEncoder", "ConvolutionalVQVAE", "JointLocationModel", "LocationModule"]
