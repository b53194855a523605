"""Model layer: the VQ-VAE with its encoder and decoder, the echoed-speech
composite, the location regressors, and the EnCodec neural audio codec."""

from .conv_vqvae import ConvolutionalEncoder, ConvolutionalVQVAE, DeconvolutionalDecoder, sequence_sharding
from .echoed_speech import EchoedSpeechReconModel
from .encodec import EncodecModel
from .location import JointLocationModel, LocationModule

__all__ = [
    "ConvolutionalEncoder", "ConvolutionalVQVAE", "DeconvolutionalDecoder", "EchoedSpeechReconModel", "EncodecModel",
    "JointLocationModel", "LocationModule", "sequence_sharding",
]
