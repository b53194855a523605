"""Model layer: the VQ-VAE with its encoder and decoder, the echoed-speech
composite, and the location regressors."""

from .conv_vqvae import ConvolutionalEncoder, ConvolutionalVQVAE, DeconvolutionalDecoder, sequence_sharding
from .echoed_speech import EchoedSpeechReconModel
from .location import JointLocationModel, LocationModule

__all__ = [
    "ConvolutionalEncoder", "ConvolutionalVQVAE", "DeconvolutionalDecoder", "EchoedSpeechReconModel",
    "JointLocationModel", "LocationModule", "sequence_sharding",
]
