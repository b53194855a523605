"""A plain PyTorch reference of EnCodec (Défossez et al., arXiv:2210.13438)
served: waveform to codes to waveform.

Written equation by equation from transformers' ``models/encodec/
modeling_encodec.py`` (``EncodecConv1d`` with ``_get_extra_padding_for_conv1d``
and ``_pad1d``, ``EncodecConvTranspose1d``, ``EncodecResnetBlock``,
``EncodecLSTM``, ``EncodecEncoder``, ``EncodecDecoder``,
``EncodecEuclideanCodebook.quantize``, ``EncodecResidualVectorQuantizer.
encode/decode``, ``EncodecModel.encode/decode``) at its defaults, the
published ``facebook/encodec_24khz`` configuration. It imports nothing but
torch: parameters are a flat dict under the published checkpoint's keys, and
every function computes in the dtype of what it is given. TF32 is off.

Departures from the published code, none of which changes a result:

* weight norm is computed as ``g * v / ||v||`` from the stored pair at each
  use, where torch's parametrization computes ``v * (g / ||v||)``;
* the LSTM is its equations stepped over time (gates i, f, g, o; zero initial
  state), where the published module calls ``nn.LSTM``;
* the extra right padding is the published formula in integer arithmetic,
  where the published code takes the ceiling of a float quotient;
* only the paths the 24 kHz model takes: causal convs with reflect padding,
  weight norm, no input normalisation, no chunking.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = Dict[str, torch.Tensor]

# the published configuration's keys that shape the served model
CONFIG = {
    "sampling_rate": 24000, "audio_channels": 1, "num_filters": 32, "hidden_size": 128,
    "upsampling_ratios": [8, 5, 4, 2], "kernel_size": 7, "last_kernel_size": 7, "residual_kernel_size": 3,
    "num_residual_layers": 1, "dilation_growth_rate": 2, "compress": 2, "num_lstm_layers": 2,
    "codebook_size": 1024, "target_bandwidths": [1.5, 3.0, 6.0, 12.0, 24.0],
}


def hop_length(cfg: dict) -> int:
    return math.prod(cfg["upsampling_ratios"])


def frame_rate(cfg: dict) -> int:
    return math.ceil(cfg["sampling_rate"] / hop_length(cfg))


def num_quantizers(cfg: dict) -> int:
    """``EncodecConfig.num_quantizers``: the stages of the largest bandwidth."""
    return int(1000 * cfg["target_bandwidths"][-1] // (frame_rate(cfg) * math.ceil(math.log2(cfg["codebook_size"]))))


def quantizers_for_bandwidth(cfg: dict, bandwidth: float) -> int:
    """``get_num_quantizers_for_bandwidth``, bounded by the stages there are."""
    n = int(max(1, math.floor(bandwidth * 1000 / (math.log2(cfg["codebook_size"]) * frame_rate(cfg)))))
    return min(n, num_quantizers(cfg))


# ----------------------------------------------------------------- layers


def weight(p: Params, prefix: str) -> torch.Tensor:
    """The weight-normed weight: g * v / ||v||, the norm over every dim but the first."""
    v = p[prefix + "weight_v"]
    return p[prefix + "weight_g"] * v / torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True)


def pad1d(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``_pad1d`` in reflect mode: zeros on the right first where the input
    is no longer than the padding, cut off after."""
    length = x.shape[-1]
    extra = max(left, right) - length + 1 if length <= max(left, right) else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra]


def conv(p: Params, prefix: str, x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """``EncodecConv1d`` (causal): ``k_eff - stride`` on the left, the extra
    padding that completes the last frame on the right."""
    k_eff = (k - 1) * dilation + 1
    padding_total = k_eff - stride
    length = x.shape[-1]
    n_frames = -(-(length - k_eff + padding_total) // stride)  # ceil((L - k + pt) / s + 1) - 1
    extra = n_frames * stride + k_eff - padding_total - length
    x = pad1d(x, padding_total, extra)
    return F.conv1d(x, weight(p, prefix + "conv."), p[prefix + "conv.bias"], stride=stride, dilation=dilation)


def conv_transpose(p: Params, prefix: str, x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``EncodecConvTranspose1d`` (causal, ``trim_right_ratio`` 1): the
    ``k - stride`` padding trimmed from the right."""
    y = F.conv_transpose1d(x, weight(p, prefix + "conv."), p[prefix + "conv.bias"], stride=stride)
    return y[..., : y.shape[-1] - (k - stride)]


def resnet_block(p: Params, prefix: str, x: torch.Tensor, cfg: dict, dilations) -> torch.Tensor:
    """``EncodecResnetBlock``: [ELU, conv k3 to dim/compress, ELU, conv k1 back] plus a 1x1 conv shortcut."""
    y = conv(p, prefix + "block.1.", F.elu(x), cfg["residual_kernel_size"], dilation=dilations[0])
    y = conv(p, prefix + "block.3.", F.elu(y), 1, dilation=dilations[1])
    return conv(p, prefix + "shortcut.", x, 1) + y


def lstm(p: Params, prefix: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """``EncodecLSTM``: the LSTM over time of (B, C, T) plus its input."""
    seq = x.permute(2, 0, 1)  # (T, B, C)
    h_in = seq
    for layer in range(layers):
        w_ih, w_hh = p[f"{prefix}lstm.weight_ih_l{layer}"], p[f"{prefix}lstm.weight_hh_l{layer}"]
        b = p[f"{prefix}lstm.bias_ih_l{layer}"] + p[f"{prefix}lstm.bias_hh_l{layer}"]
        hidden = w_hh.shape[1]
        h = h_in.new_zeros(h_in.shape[1], hidden)
        c = h_in.new_zeros(h_in.shape[1], hidden)
        outs = []
        for t in range(h_in.shape[0]):
            i, f, g, o = (h_in[t] @ w_ih.T + h @ w_hh.T + b).chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        h_in = torch.stack(outs)
    return (h_in + seq).permute(1, 2, 0)


def encoder(p: Params, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``EncodecEncoder``: (B, C, L) -> (B, hidden_size, ceil(L / hop))."""
    i, res = 0, cfg["num_residual_layers"]
    x = conv(p, f"encoder.layers.{i}.", x, cfg["kernel_size"])
    for ratio in reversed(cfg["upsampling_ratios"]):
        for j in range(res):
            i += 1
            x = resnet_block(p, f"encoder.layers.{i}.", x, cfg, (cfg["dilation_growth_rate"] ** j, 1))
        i += 2  # the ELU, then the strided conv
        x = conv(p, f"encoder.layers.{i}.", F.elu(x), ratio * 2, stride=ratio)
    i += 1
    x = lstm(p, f"encoder.layers.{i}.", x, cfg["num_lstm_layers"])
    i += 2
    return conv(p, f"encoder.layers.{i}.", F.elu(x), cfg["last_kernel_size"])


def decoder(p: Params, z: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``EncodecDecoder``: (B, hidden_size, T) -> (B, C, T * hop)."""
    res = cfg["num_residual_layers"]
    x = conv(p, "decoder.layers.0.", z, cfg["kernel_size"])
    x = lstm(p, "decoder.layers.1.", x, cfg["num_lstm_layers"])
    i = 1
    for ratio in cfg["upsampling_ratios"]:
        i += 2
        x = conv_transpose(p, f"decoder.layers.{i}.", F.elu(x), ratio * 2, ratio)
        for j in range(res):
            i += 1
            x = resnet_block(p, f"decoder.layers.{i}.", x, cfg, (cfg["dilation_growth_rate"] ** j, 1))
    i += 2
    return conv(p, f"decoder.layers.{i}.", F.elu(x), cfg["last_kernel_size"])


# -------------------------------------------------------------- quantizer


def nearest(rows: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``EncodecEuclideanCodebook.quantize``: the largest ``-||x - e||^2``,
    written as the published code writes it; the first index on ties."""
    dist = -(rows.pow(2).sum(1, keepdim=True) - 2 * rows @ embed.T + embed.T.pow(2).sum(0, keepdim=True))
    return dist.max(dim=-1).indices


def rvq_encode(p: Params, z: torch.Tensor, n_q: int) -> torch.Tensor:
    """``EncodecResidualVectorQuantizer.encode``: codes (n_q, B, T) of z (B, D, T)."""
    residual = z.permute(0, 2, 1)
    codes = []
    for i in range(n_q):
        embed = p[f"quantizer.layers.{i}.codebook.embed"]
        ids = nearest(residual.reshape(-1, residual.shape[-1]), embed).view(*residual.shape[:-1])
        residual = residual - F.embedding(ids, embed)
        codes.append(ids)
    return torch.stack(codes)


def rvq_decode(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """``EncodecResidualVectorQuantizer.decode``: the sum from zero, in stage
    order, of each stage's rows; (B, D, T) of codes (n_q, B, T)."""
    out = torch.tensor(0.0, dtype=p["quantizer.layers.0.codebook.embed"].dtype, device=codes.device)
    for i, ids in enumerate(codes):
        out = out + F.embedding(ids, p[f"quantizer.layers.{i}.codebook.embed"]).permute(0, 2, 1)
    return out


def serve(p: Params, audio: torch.Tensor, cfg: dict = CONFIG, bandwidth: float = 24.0,
          codes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``EncodecModel`` forward on ``audio`` (B, L): ``(codes (B, n_q, T),
    audio (B, L))``, the decoder's output cut to L. ``codes`` (B, n_q, T),
    where given, are decoded in place of the reference's own."""
    x = audio.unsqueeze(1)
    if codes is None:
        codes = rvq_encode(p, encoder(p, x, cfg), quantizers_for_bandwidth(cfg, bandwidth)).transpose(0, 1)
    out = decoder(p, rvq_decode(p, codes.transpose(0, 1).long()), cfg)
    return codes, out[..., : x.shape[-1]].reshape(audio.shape)
