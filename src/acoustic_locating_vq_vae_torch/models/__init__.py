"""Model layer: the VQ-VAE with its encoder and decoder, and the location
regressors."""

from .conv_vqvae import ConvolutionalEncoder, ConvolutionalVQVAE, DeconvolutionalDecoder
from .location import JointLocationModel, LocationModule

__all__ = ["ConvolutionalEncoder", "ConvolutionalVQVAE", "DeconvolutionalDecoder", "JointLocationModel", "LocationModule"]
