"""EnCodec, the residual-VQ neural audio codec (Défossez et al., "High
Fidelity Neural Audio Compression", arXiv:2210.13438), served: waveform to
codes to waveform.

The layers are those of transformers' ``models/encodec/modeling_encodec.py``
(``EncodecEncoder``, ``EncodecDecoder``, ``EncodecResnetBlock``,
``EncodecLSTM``, ``EncodecResidualVectorQuantizer``) with its defaults, which
are the published ``facebook/encodec_24khz`` configuration: the SEANet encoder
(a k7 conv to ``num_filters``, then per ratio of ``upsampling_ratios``
reversed a residual block and a strided conv doubling the width, a two-layer
LSTM with a skip, a k7 conv to ``hidden_size``), the residual quantizer of
``ops/vq.py`` (``num_quantizers`` stages of ``codebook_size`` codes), and the
mirrored decoder with causal transposed convs. Every conv is causal with
reflect padding and weight norm (``ops/conv.py``); the state-dict keys are the
published checkpoint's (``encoder.layers.0.conv.weight_g``, ...,
``quantizer.layers.31.codebook.embed``).

Not ported, as the 24 kHz model does not use them: input normalisation
(``normalize``), chunked encoding with overlap-add, time-group norm and
non-causal padding. A served call runs no host synchronisation.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.conv import Conv1d, ConvTranspose1d
from ..ops.span import span
from ..ops.vq import ResidualVectorQuantizer

__all__ = ["EncodecModel"]


class _Conv(nn.Module):
    """``EncodecConv1d``: a causal, reflect-padded, weight-normed conv under ``conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv1d(cin, cout, kernel_size, padding="causal", init_mode="torch_default", stride=stride,
                           dilation=dilation, weight_norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _ConvTranspose(nn.Module):
    """``EncodecConvTranspose1d``: a causal, weight-normed transposed conv under ``conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv = ConvTranspose1d(cin, cout, kernel_size, padding="causal", stride=stride, weight_norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _ResnetBlock(nn.Module):
    """``EncodecResnetBlock``: ELU, conv to ``dim // compress``, ELU, 1x1 conv
    back, plus a 1x1 conv shortcut."""

    def __init__(self, dim: int, kernel_size: int, dilations: Sequence[int], compress: int):
        super().__init__()
        hidden = dim // compress
        self.block = nn.ModuleList([nn.ELU(), _Conv(dim, hidden, kernel_size, dilation=dilations[0]),
                                    nn.ELU(), _Conv(hidden, dim, 1, dilation=dilations[1])])
        self.shortcut = _Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.block:
            y = layer(y)
        return self.shortcut(x) + y


class _LSTM(nn.Module):
    """``EncodecLSTM``: an LSTM over time in the conv layout, plus its input."""

    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(2, 0, 1)
        return (self.lstm(x)[0] + x).permute(1, 2, 0)


class EncodecModel(nn.Module):
    """EnCodec with the published 24 kHz configuration as its defaults.

    ``forward(audio (B, L) or (B, C, L), n_q)`` -> ``(codes (B, n_q, T) int32,
    audio of the input's shape)``, ``T = ceil(L / hop)``; the decoder's
    output is cut to ``L`` as EnCodec's ``decode`` cuts it to the padding
    mask. Spans: ``codec.encode`` (the encoder's convs and LSTM),
    ``rvq.encode``, ``rvq.decode`` (``ops/vq.py``) and ``codec.decode``."""

    def __init__(
        self,
        sampling_rate: int = 24000,
        audio_channels: int = 1,
        num_filters: int = 32,
        hidden_size: int = 128,
        upsampling_ratios: Sequence[int] = (8, 5, 4, 2),
        kernel_size: int = 7,
        last_kernel_size: int = 7,
        residual_kernel_size: int = 3,
        num_residual_layers: int = 1,
        dilation_growth_rate: int = 2,
        compress: int = 2,
        num_lstm_layers: int = 2,
        codebook_size: int = 1024,
        codebook_dim: Optional[int] = None,
        target_bandwidths: Sequence[float] = (1.5, 3.0, 6.0, 12.0, 24.0),
    ):
        super().__init__()
        self.hop_length = math.prod(upsampling_ratios)
        self.frame_rate = math.ceil(sampling_rate / self.hop_length)
        self.codebook_size = codebook_size
        self.target_bandwidths = tuple(target_bandwidths)
        # EncodecConfig.num_quantizers: the stages of the largest bandwidth
        self.num_quantizers = int(1000 * self.target_bandwidths[-1]
                                  // (self.frame_rate * math.ceil(math.log2(codebook_size))))
        nf, res_k = num_filters, residual_kernel_size

        def blocks(dim: int):
            return [_ResnetBlock(dim, res_k, (dilation_growth_rate ** j, 1), compress)
                    for j in range(num_residual_layers)]

        enc, scale = [_Conv(audio_channels, nf, kernel_size)], 1
        for ratio in reversed(upsampling_ratios):
            enc += blocks(scale * nf) + [nn.ELU(), _Conv(scale * nf, scale * nf * 2, ratio * 2, stride=ratio)]
            scale *= 2
        enc += [_LSTM(scale * nf, num_lstm_layers), nn.ELU(), _Conv(scale * nf, hidden_size, last_kernel_size)]
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(enc)

        dec = [_Conv(hidden_size, scale * nf, kernel_size), _LSTM(scale * nf, num_lstm_layers)]
        for ratio in upsampling_ratios:
            dec += [nn.ELU(), _ConvTranspose(scale * nf, scale * nf // 2, ratio * 2, ratio)] + blocks(scale * nf // 2)
            scale //= 2
        dec += [nn.ELU(), _Conv(nf, audio_channels, last_kernel_size)]
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(dec)

        self.quantizer = ResidualVectorQuantizer(self.num_quantizers, codebook_size, codebook_dim or hidden_size)

    def quantizers_for_bandwidth(self, bandwidth: float) -> int:
        """The stages run at ``bandwidth`` kbps (``get_num_quantizers_for_bandwidth``,
        which EnCodec's ``layers[:n]`` bounds by the stages there are)."""
        n = int(max(1, math.floor(bandwidth * 1000 / (math.log2(self.codebook_size) * self.frame_rate))))
        return min(n, self.num_quantizers)

    @staticmethod
    def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            x = layer(x)
        return x

    def encode(self, audio: torch.Tensor, n_q: int) -> torch.Tensor:
        """int32 codes ``(B, n_q, T)`` of ``audio`` (B, C, L)."""
        with span("codec.encode"):
            z = self._run(self.encoder.layers, audio)
        b, d, t = z.shape
        codes = self.quantizer.encode(z.transpose(1, 2).reshape(b * t, d), n_q)
        return codes.reshape(n_q, b, t).transpose(0, 1)

    def decode(self, codes: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        """Audio ``(B, C, T * hop)`` of ``codes`` (B, n_q, T), cut to ``length``."""
        b, n_q, t = codes.shape
        z = self.quantizer.decode(codes.transpose(0, 1).reshape(n_q, b * t))
        z = z.reshape(b, t, -1).transpose(1, 2)
        with span("codec.decode"):
            out = self._run(self.decoder.layers, z)
        return out if length is None else out[..., :length]

    def forward(self, audio: torch.Tensor, n_q: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = audio.unsqueeze(1) if audio.dim() == 2 else audio
        codes = self.encode(x, self.num_quantizers if n_q is None else n_q)
        out = self.decode(codes, x.shape[-1])
        return codes, out.reshape(audio.shape)
