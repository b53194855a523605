"""Plain PyTorch reference of the EnCodec 24 kHz codec, served: the
benchmark's copy of ``tests/encodec_reference.py`` (equation by equation
from transformers' ``modeling_encodec.py``; its docstring lists the
departures from the published code, none of which changes a result), with
the convolutions and matrix products routed through ``reference/model.py``'s
TF32 rounding for the control on the CPU, and what the check reads beside
it: the stage-by-stage judgement of a program's codes.

Parameters are a flat dict under the published checkpoint's keys, and every
function computes in the dtype of what it is given (float64 for the check,
float32 for the control and the codebooks' seeding). It imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .model import _op, matmul

Params = Dict[str, torch.Tensor]

# the published configuration's keys that shape the served model
MODEL_KEYS = ("sampling_rate", "audio_channels", "num_filters", "hidden_size", "upsampling_ratios", "kernel_size",
              "last_kernel_size", "residual_kernel_size", "num_residual_layers", "dilation_growth_rate", "compress",
              "num_lstm_layers", "codebook_size", "target_bandwidths")


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
    return F.conv1d(_op(x), _op(weight(p, prefix + "conv.")), p[prefix + "conv.bias"], stride=stride,
                    dilation=dilation)


def conv_transpose(p: Params, prefix: str, x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``EncodecConvTranspose1d`` (causal, ``trim_right_ratio`` 1): the
    ``k - stride`` padding trimmed from the right."""
    y = F.conv_transpose1d(_op(x), _op(weight(p, prefix + "conv.")), p[prefix + "conv.bias"], stride=stride)
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
        h = h_in.new_zeros(h_in.shape[1], w_hh.shape[1])
        c = torch.zeros_like(h)
        outs = []
        for t in range(h_in.shape[0]):
            i, f, g, o = (matmul(h_in[t], w_ih.T) + matmul(h, w_hh.T) + b).chunk(4, dim=1)
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
    dist = -(rows.pow(2).sum(1, keepdim=True) - 2 * matmul(rows, embed.T) + embed.T.pow(2).sum(0, keepdim=True))
    return dist.max(dim=-1).indices


def embed(p: Params, i: int) -> torch.Tensor:
    return p[f"quantizer.layers.{i}.codebook.embed"]


def rvq_encode(p: Params, z: torch.Tensor, n_q: int) -> torch.Tensor:
    """``EncodecResidualVectorQuantizer.encode``: codes (B, n_q, T) of z (B, D, T)."""
    residual = z.transpose(1, 2)
    codes = []
    for i in range(n_q):
        ids = nearest(residual.reshape(-1, residual.shape[-1]), embed(p, i)).view(*residual.shape[:-1])
        residual = residual - F.embedding(ids, embed(p, i))
        codes.append(ids)
    return torch.stack(codes, dim=1)


def rvq_decode(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """``EncodecResidualVectorQuantizer.decode``: the sum from zero, in stage
    order, of each stage's rows; (B, D, T) of codes (B, n_q, T)."""
    out = torch.tensor(0.0, dtype=embed(p, 0).dtype, device=codes.device)
    for i in range(codes.shape[1]):
        out = out + F.embedding(codes[:, i].long(), embed(p, i)).transpose(1, 2)
    return out


def decode(p: Params, codes: torch.Tensor, cfg: dict, length: int) -> torch.Tensor:
    """Audio (B, length) of codes (B, n_q, T): the decoder's output cut to length."""
    return decoder(p, rvq_decode(p, codes), cfg)[:, 0, :length]


def judge_codes(p: Params, z: torch.Tensor, codes: torch.Tensor, tie: float) -> Tuple[int, int, float]:
    """The program's ``codes`` (B, n_q, T) against the reference's nearest,
    stage by stage, each stage's residual left by the program's own earlier
    codes from the reference's latent ``z`` (B, D, T). A code that differs
    is off unless its squared distance exceeds the nearest one's by less
    than ``tie`` of ``||r||^2 + ||e_best||^2`` (a near tie, where which code
    is nearest is a matter of rounding). Returns ``(off, differing, the
    largest relative gap of a differing code)``."""
    d = z.shape[1]
    residual = z.transpose(1, 2).reshape(-1, d)
    off = differ = 0
    worst = 0.0
    for i in range(codes.shape[1]):
        e = embed(p, i)
        got = codes[:, i].reshape(-1).long().to(z.device)
        r2 = (residual * residual).sum(1)
        e2 = (e * e).sum(1)
        d2 = r2[:, None] - 2.0 * (residual @ e.T) + e2[None]
        best = torch.argmin(d2, dim=1)
        gap = (d2.gather(1, got[:, None])[:, 0] - d2.gather(1, best[:, None])[:, 0]) / (r2 + e2[best])
        wrong = got != best
        off += int((wrong & (gap >= tie)).sum())
        differ += int(wrong.sum())
        if bool(wrong.any()):
            worst = max(worst, float(gap[wrong].max()))
        residual = residual - e[got]
    return off, differ, worst
