"""Configuration ``encodec_24khz``: the EnCodec 24 kHz neural audio codec
(arXiv:2210.13438; ``facebook/encodec_24khz``), served at 24 kbps: the
SEANet encoder and decoder with their two-layer LSTMs and the 32-stage
residual quantizer, in FP32, as ``eval/serving.py:make_codec_serving_fn``
serves it.

The harness loads this module by the configuration's name; see
``echoed_composite.py``. The published keys live at the top level of
``encodec_24khz.json``; :func:`scaled` cuts the widths for a run at reduced
width (the tests' CPU runs), as the program's ``CodecTask`` cuts them.
:func:`prepare` sets what :func:`param_spec`'s random draw cannot: each
``weight_g`` to the norm of its ``weight_v``, and the codebooks from the
reference's residuals of a seeded batch (``assumed`` in the file).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from reference import encodec as ref

# no quantizer module of the program is tapped: the codes are the served call's own output
QUANTIZERS: Dict[str, str] = {}


def scaled(cfg: dict, width_scale: float) -> dict:
    """``cfg`` with ``num_filters`` and ``codebook_size`` scaled as
    ``CodecTask`` scales them (``max(4, int(v * width_scale))``; the codebook
    dim stays); ``cfg`` itself at width 1."""
    if width_scale == 1.0:
        return cfg
    out = dict(cfg)
    for key in ("num_filters", "codebook_size"):
        out[key] = max(4, int(cfg[key] * width_scale))
    return out


def build(cfg: dict, geo, width_scale: float):
    """The program's ``CodecTask`` of the configuration."""
    from acoustic_locating_vq_vae_torch.train.tasks import make_task

    kw = {k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]) for k in ref.MODEL_KEYS}
    return make_task("codec", width_scale=width_scale, bandwidth=cfg["bandwidth"], **kw)


def _convs(cfg: dict) -> Iterator[Tuple[str, int, int, int, int, bool, int]]:
    """``(prefix, in, out, kernel, stride, transposed, the input's length
    divisor)`` of every conv, in the published layout."""
    nf, res, ratios = cfg["num_filters"], cfg["num_residual_layers"], cfg["upsampling_ratios"]

    def block(prefix, dim, div):
        hidden = dim // cfg["compress"]
        yield prefix + "block.1.", dim, hidden, cfg["residual_kernel_size"], 1, False, div
        yield prefix + "block.3.", hidden, dim, 1, 1, False, div
        yield prefix + "shortcut.", dim, dim, 1, 1, False, div

    i, scale, div = 0, 1, 1
    yield "encoder.layers.0.", cfg["audio_channels"], nf, cfg["kernel_size"], 1, False, div
    for ratio in reversed(ratios):
        for _ in range(res):
            i += 1
            yield from block(f"encoder.layers.{i}.", scale * nf, div)
        i += 2
        yield f"encoder.layers.{i}.", scale * nf, scale * nf * 2, ratio * 2, ratio, False, div
        scale, div = scale * 2, div * ratio
    yield f"encoder.layers.{i + 3}.", scale * nf, cfg["hidden_size"], cfg["last_kernel_size"], 1, False, div
    yield "decoder.layers.0.", cfg["hidden_size"], scale * nf, cfg["kernel_size"], 1, False, div
    i = 1
    for ratio in ratios:
        i += 2
        yield f"decoder.layers.{i}.", scale * nf, scale * nf // 2, ratio * 2, ratio, True, div
        scale, div = scale // 2, div // ratio
        for _ in range(res):
            i += 1
            yield from block(f"decoder.layers.{i}.", scale * nf, div)
    yield f"decoder.layers.{i + 2}.", nf, cfg["audio_channels"], cfg["last_kernel_size"], 1, False, div


def _lstms(cfg: dict) -> List[str]:
    ratios, res = cfg["upsampling_ratios"], cfg["num_residual_layers"]
    return [f"encoder.layers.{len(ratios) * (res + 2) + 1}.lstm.", "decoder.layers.1.lstm."]


def param_spec(cfg: dict):
    """``(key, shape, init, fan_in)`` of every state-dict entry, under the
    published checkpoint's keys."""
    spec = []
    for prefix, cin, cout, k, stride, transposed, _ in _convs(cfg):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        fan = cin * k // stride if transposed else cin * k  # the inputs one output sample sums
        spec += [(prefix + "conv.bias", (cout,), "default", cin * k),
                 (prefix + "conv.weight_g", (shape[0], 1, 1), "default", 1),
                 (prefix + "conv.weight_v", shape, "kaiming", fan)]
    h = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    for prefix in _lstms(cfg):
        for layer in range(cfg["num_lstm_layers"]):
            spec += [(f"{prefix}{name}_l{layer}", shape, "default", h)
                     for name, shape in (("weight_ih", (4 * h, h)), ("weight_hh", (4 * h, h)),
                                         ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,)))]
    k, d = cfg["codebook_size"], cfg["codebook_dim"]
    for i in range(ref.num_quantizers(cfg)):
        p = f"quantizer.layers.{i}.codebook."
        spec += [(p + "inited", (1,), "default", 1), (p + "cluster_size", (k,), "default", 1),
                 (p + "embed", (k, d), "codebook", k), (p + "embed_avg", (k, d), "codebook", k)]
    return spec


def codebook_inputs(cfg: dict, x: torch.Tensor):
    """None from the harness's spectrograms: :func:`prepare` seeds the codebooks."""
    return []


def prepare(params: Dict[str, torch.Tensor], cfg: dict, audio: torch.Tensor, gen: torch.Generator) -> None:
    """In place: each ``weight_g`` the norm of its ``weight_v``; then each
    stage's codebook ``codebook_size`` distinct rows, drawn from ``gen``, of
    the residual the earlier stages leave of the reference's latent of
    ``audio`` (B, L), worked out in float32 with TF32 off; a row picked once
    is left out of later draws (its residual is zero). The codebook state
    the served model does not read: ``inited`` 1, ``cluster_size`` 1,
    ``embed_avg`` the codebook."""
    with torch.no_grad():
        for key in [k for k in params if k.endswith("weight_g")]:
            v = params[key[:-1] + "v"]
            params[key] = torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True)
        k, n_q = cfg["codebook_size"], ref.num_quantizers(cfg)
        rows = torch.cat([ref.encoder(params, audio[i: i + 16, None], cfg) for i in range(0, audio.shape[0], 16)])
        residual = rows.transpose(1, 2).reshape(-1, rows.shape[1])
        free = torch.ones(residual.shape[0], dtype=torch.bool, device=residual.device)
        for i in range(n_q):
            left = free.nonzero()[:, 0]
            if left.numel() < k:
                raise ValueError(f"{residual.shape[0]} latent rows cannot seed {n_q} codebooks of {k}")
            pick = left[torch.randperm(left.numel(), generator=gen, device=gen.device)[:k]]
            codebook = residual[pick].contiguous()
            free[pick] = False
            p = f"quantizer.layers.{i}.codebook."
            params[p + "embed"], params[p + "embed_avg"] = codebook, codebook.clone()
            params[p + "inited"] = torch.ones_like(params[p + "inited"])
            params[p + "cluster_size"] = torch.ones_like(params[p + "cluster_size"])
            residual = residual - codebook[ref.nearest(residual, codebook)]


def seed_clips(cfg: dict) -> int:
    """Clips whose latent rows seed every codebook with a codebook's rows to spare."""
    frames = math.ceil(cfg["geometry"]["audio_samples"] / ref.hop_length(cfg))
    return math.ceil((ref.num_quantizers(cfg) + 1) * cfg["codebook_size"] / frames)


def counts(cfg: dict, kind: str, batch: int) -> Dict:
    """FLOPs of one served call of ``batch`` clips of the geometry's
    ``audio_samples`` at the configuration's bandwidth: the convs (a conv's
    output samples, or a transposed conv's input samples, times in x out x
    k x 2), the LSTMs (4 gates, input and recurrent products, each frame and
    layer) and the assignments' cross terms; the assignment calls
    ``vq_calls`` [(N, D, K)], one a stage."""
    if kind != "serve":
        raise ValueError(f"no {kind!r} count for {__name__}")
    length = cfg["geometry"]["audio_samples"]
    frames = math.ceil(length / ref.hop_length(cfg))
    conv = 0.0
    for _, cin, cout, k, stride, transposed, div in _convs(cfg):
        n_in = math.ceil(length / div)
        n_out = n_in * stride if transposed else math.ceil(n_in / stride)
        conv += 2.0 * batch * (n_in if transposed else n_out) * cin * cout * k
    h = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    lstm = 2 * cfg["num_lstm_layers"] * 2.0 * batch * frames * 4 * h * (h + h)
    n_q, d, k = ref.quantizers_for_bandwidth(cfg, cfg["bandwidth"]), cfg["codebook_dim"], cfg["codebook_size"]
    vq = n_q * 2.0 * batch * frames * d * k
    return {"model": conv + lstm + vq, "conv": conv, "vq_calls": [(batch * frames, d, k)] * n_q}
