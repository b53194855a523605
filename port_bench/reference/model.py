"""Plain PyTorch reference of the two benchmarked models, their losses, a
training step with Adam, and the joint localizer's serving output.

Written from the reference repository (guy3540/Acoustic_Locating_VQ-VAE:
vq_vae/convolutional_vq_vae.py, modules/residual.py, residual_stack.py,
vector_quantizer.py, echoed_speech_model.py, location_model.py and
scripts/train_echoed_speech.py, train_location.py) with the quirks the port
keeps as its defaults: tied residual layers, the in-place ReLU that turns the
encoder's outer skip into ``relu(x1)``, the memory-order VQ flatten of the
echoed composite, batch-shared decoder jitter. It imports nothing of the
program: parameters are a flat dict of tensors under the reference's
state-dict keys, and every function computes in the dtype of what it is
given (float64 for the reference, float32 for the control).

``tf32_emulated``: a CPU has no TF32, so the control's reduced precision is
emulated there by rounding the operands of every convolution and matrix
product to TF32's 10-bit mantissa; on the card the control runs real TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_TF32 = {"on": False}


@contextlib.contextmanager
def tf32_emulated(on: bool):
    """While open (with ``on``), operands of convolutions and matmuls are
    rounded to TF32 (10 mantissa bits, round to nearest even)."""
    saved = _TF32["on"]
    _TF32["on"] = on
    try:
        yield
    finally:
        _TF32["on"] = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value; the gradient
    passes through as if unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _op(x: torch.Tensor) -> torch.Tensor:
    return round_tf32(x) if _TF32["on"] and x.dtype == torch.float32 else x


def conv1d(x, w, b=None, padding=1):
    return F.conv1d(_op(x), _op(w), b, padding=padding)


def conv_transpose1d(x, w, b=None, padding=1):
    return F.conv_transpose1d(_op(x), _op(w), b, padding=padding)


def linear(x, w, b):
    return F.linear(_op(x), _op(w), b)


def matmul(a, b):
    return _op(a) @ _op(b)


# ---------------------------------------------------------------- parameters


def _scale(v: int, width_scale: float) -> int:
    return max(4, int(v * width_scale))


def _conv_spec(prefix: str, cin: int, cout: int, k: int, bias: bool = True, default_init: bool = False):
    fan_in = cin * k
    out = [(prefix + "weight", (cout, cin, k), "default" if default_init else "kaiming", fan_in)]
    if bias:
        out.append((prefix + "bias", (cout,), "default", fan_in))
    return out


def _convt_spec(prefix: str, cin: int, cout: int, k: int = 3):
    fan_in = cin * k  # the JAX module's fan-in, which the port keeps
    return [(prefix + "weight", (cin, cout, k), "kaiming", fan_in), (prefix + "bias", (cout,), "default", fan_in)]


def _stack_spec(prefix: str, hidden: int, res_hidden: int, layers: int):
    """The tied residual stack: every layer's keys, all naming layer 0's tensors (the alias column)."""
    spec = []
    for i in range(layers):
        p = f"{prefix}_residual_stack._layers.{i}._block."
        spec += _conv_spec(p + "1.", hidden, res_hidden, 3, bias=False)
        spec += _conv_spec(p + "3.", res_hidden, hidden, 1, bias=False, default_init=True)
    return spec


def decoder_spec(prefix: str, d: int, hidden: int, res_hidden: int, layers: int, out: int):
    spec = _conv_spec(prefix + "_conv_1.", d, hidden, 3)
    spec += _stack_spec(prefix, hidden, res_hidden, layers)
    spec += _convt_spec(prefix + "_conv_trans_1.", hidden, hidden)
    spec += _convt_spec(prefix + "_conv_trans_2.", hidden, hidden)
    spec += _convt_spec(prefix + "_conv_trans_3.", hidden, out)
    return spec


def vqvae_spec(prefix: str, b: dict, decoder: bool, decoder_out: Optional[int] = None):
    h, rh, d, k, n = b["num_hiddens"], b["num_residual_hiddens"], b["embedding_dim"], b["num_embeddings"], \
        b["num_residual_layers"]
    spec = _conv_spec(prefix + "_encoder._conv_1.", b["in_channels"], h, 3)
    spec += _stack_spec(prefix + "_encoder.", h, rh, n)
    spec += _conv_spec(prefix + "_pre_vq_conv.", h, d, 3)
    spec += [(prefix + "_vq._embedding.weight", (k, d), "codebook", k)]
    if decoder:
        spec += decoder_spec(prefix + "_decoder.", d, h, rh, n, decoder_out or b["in_channels"])
    return spec


def tied_source(key: str) -> str:
    """The key whose tensor a tied residual layer's key shares: layer 0's."""
    marker = "._layers."
    if marker not in key:
        return key
    head, tail = key.split(marker, 1)
    return head + marker + "0." + tail.split(".", 1)[1]


def scaled_config(cfg: dict, width_scale: float) -> dict:
    """``cfg`` with every width scaled as the port's tasks scale them
    (``max(4, int(v * width_scale))``); the input channels and the
    spectrogram's bins (the data's shape) stay."""
    if width_scale == 1.0:
        return cfg
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    for branch in ("speech", "rir", "decoder"):
        if branch in out:
            for key in ("num_hiddens", "num_residual_hiddens", "embedding_dim", "num_embeddings"):
                if key in out[branch]:
                    out[branch][key] = _scale(out[branch][key], width_scale)
    return out


# ------------------------------------------------------------------- forward


def znorm(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    """``(x - mean) / (std + eps)``, unbiased std (train_speech.py:64)."""
    mean = x.mean(dim=dim, keepdim=True)
    var = ((x - mean) ** 2).sum(dim=dim, keepdim=True) / max(x.shape[dim] - 1, 1)
    return (x - mean) / (var.sqrt() + eps)


def _stack(p: Params, prefix: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    w1 = p[prefix + "_residual_stack._layers.0._block.1.weight"]
    w2 = p[prefix + "_residual_stack._layers.0._block.3.weight"]
    for _ in range(layers):  # tied: one block applied ``layers`` times
        rx = F.relu(x)  # the in-place ReLU of the reference makes the skip relu(x)
        x = rx + conv1d(F.relu(conv1d(rx, w1, padding=1)), w2, padding=0)
    return F.relu(x)


def encoder(p: Params, prefix: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    x1 = conv1d(x, p[prefix + "_encoder._conv_1.weight"], p[prefix + "_encoder._conv_1.bias"])
    return _stack(p, prefix + "_encoder.", x1, layers) + F.relu(x1)


def pre_vq(p: Params, prefix: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """``(B, C, L) -> (B, D, L)``, the latent the quantizer reads."""
    return conv1d(encoder(p, prefix, x, layers), p[prefix + "_pre_vq_conv.weight"], p[prefix + "_pre_vq_conv.bias"])


def nearest(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin over codes of the squared distance ``||x - e||^2``, first on ties."""
    d2 = (flat * flat).sum(1, keepdim=True) - 2.0 * matmul(flat, codebook.T) + (codebook * codebook).sum(1)[None]
    return torch.argmin(d2, dim=1)


def tie_margin(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Per row, the gap between the two least squared distances over
    ``||x||^2 + ||e_best||^2``: how near the row's assignment is to a tie."""
    x2 = (flat * flat).sum(1, keepdim=True)
    e2 = (codebook * codebook).sum(1)[None]
    d2 = x2 - 2.0 * (flat @ codebook.T) + e2
    two = torch.topk(d2, 2, dim=1, largest=False)
    best_e2 = e2[0, two.indices[:, 0]]
    return (two.values[:, 1] - two.values[:, 0]) / (x2[:, 0] + best_e2)


def quantize(z: torch.Tensor, codebook: torch.Tensor, memory_order: bool, beta: float = 0.25,
             ids: Optional[torch.Tensor] = None, follow: Optional[torch.Tensor] = None, tie: float = 0.0):
    """The frozen-codebook quantizer (vector_quantizer.py with the codebook
    frozen): ``(loss, straight-through latent (B, D, L), perplexity, the
    nearest ids (B, R), their tie margins (B, R) or None)``.
    ``memory_order`` is the reference's ``view(-1, D)`` of ``(B, D, L)``;
    otherwise rows are the channel vectors. ``ids`` (B, R), where given, are
    the codes used in place of the nearest ones (a served answer judged from
    the codes it was served with). ``follow`` (B, R), where given, are the
    codes used where the nearest code is within ``tie`` of a tie, where
    which code is nearest is a matter of rounding: the program's, so that
    the reference takes the branch the program took there."""
    b, d, length = z.shape
    flat = z.reshape(-1, d) if memory_order else z.transpose(1, 2).reshape(-1, d)
    if ids is None:
        nearest_ids = ids = nearest(flat.detach(), codebook)
        margin = tie_margin(flat.detach(), codebook).reshape(b, -1)
        if follow is not None and follow.numel() == ids.numel():
            ids = torch.where(margin.reshape(-1) < tie, follow.reshape(-1).long().to(ids.device), ids)
    else:
        nearest_ids = ids = ids.reshape(-1).long().to(z.device)
        margin = None
    q = codebook[ids]
    e_latent = ((q.detach() - flat) ** 2).mean()
    q_latent = ((q - flat) ** 2).mean().detach()
    loss = q_latent + beta * e_latent
    qz = q.reshape(b, d, length) if memory_order else q.reshape(b, length, d).transpose(1, 2)
    ste = z + (qz - z).detach()
    counts = torch.bincount(ids, minlength=codebook.shape[0]).to(z.dtype)
    probs = counts / ids.shape[0]
    perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
    return loss, ste, perplexity, nearest_ids.reshape(b, -1), margin


def jitter(x: torch.Tensor, replace: torch.Tensor, forward: torch.Tensor) -> torch.Tensor:
    """Batch-shared jitter of ``(B, D, L)`` along time (modules/jitter.py)."""
    length = x.shape[-1]
    pos = torch.arange(length, device=x.device)
    neighbor = torch.where(forward.to(x.device), pos + 1, pos - 1)
    neighbor[0], neighbor[-1] = 1, length - 2
    idx = torch.where(replace.to(x.device), neighbor, pos)
    return torch.where(replace.to(x.device), x.detach()[..., idx], x)


def decoder(p: Params, prefix: str, x: torch.Tensor, layers: int, jit=None) -> torch.Tensor:
    if jit is not None:
        x = jitter(x, *jit)
    x = conv1d(x, p[prefix + "_conv_1.weight"], p[prefix + "_conv_1.bias"])
    x = _stack(p, prefix, x, layers)
    x = F.relu(conv_transpose1d(x, p[prefix + "_conv_trans_1.weight"], p[prefix + "_conv_trans_1.bias"]))
    x = F.relu(conv_transpose1d(x, p[prefix + "_conv_trans_2.weight"], p[prefix + "_conv_trans_2.bias"]))
    return conv_transpose1d(x, p[prefix + "_conv_trans_3.weight"], p[prefix + "_conv_trans_3.bias"])


def echoed_codes(p: Params, cfg: dict, echoed_spec: torch.Tensor, follow=None, tie: float = 0.0):
    """Both frozen branches' ``(quantized, perplexity, ids, tie margins)`` of
    a batch; ``follow`` (by branch) and ``tie`` as :func:`quantize` takes them."""
    x = znorm(echoed_spec, dim=1)
    out = {}
    with torch.no_grad():
        for name, xin in (("speech", x), ("rir", x.transpose(1, 2))):
            br = cfg[name]
            z = pre_vq(p, name + "_model.", xin, br["num_residual_layers"])
            out[name] = quantize(z, p[name + "_model._vq._embedding.weight"], memory_order=True,
                                 follow=(follow or {}).get(name), tie=tie)[1:]
    return x, out


def echoed_loss(p: Params, cfg: dict, echoed_spec: torch.Tensor, jit, follow=None, tie: float = 0.0):
    """The echoed stage's loss (train_echoed_speech.py:64-89): both branches
    frozen, their latents padded and concatenated, the decoder's
    reconstruction error. Returns (loss, metrics); the metrics' ``codes`` are
    each branch's ``(ids, tie margins)``. ``follow``, ``tie``: as
    :func:`echoed_codes` takes them."""
    x, out = echoed_codes(p, cfg, echoed_spec, follow, tie)
    sq, sp = out["speech"][0], out["speech"][1]
    rq, rp = out["rir"][0], out["rir"][1]
    rq = F.pad(rq, (0, sq.shape[2] - rq.shape[2]))
    quantized = torch.cat([sq, rq], dim=1).detach()
    recon = decoder(p, "_decoder.", quantized, cfg["decoder"]["num_residual_layers"], jit)
    loss = ((recon[..., : x.shape[-1]] - x) ** 2).mean()
    codes = {name: (out[name][2], out[name][3]) for name in ("speech", "rir")}
    return loss, {"speech_perplexity": sp.detach(), "rir_perplexity": rp.detach(), "codes": codes}


def joint_latent(p: Params, cfg: dict, echoed_spec: torch.Tensor) -> torch.Tensor:
    """The joint localizer's pre-VQ latent (B, D, F) of a batch."""
    x = znorm(echoed_spec, dim=1).transpose(1, 2)
    return pre_vq(p, "rir_model.", x, cfg["rir"]["num_residual_layers"])


def joint_head(p: Params, cfg: dict, z: torch.Tensor, ids: Optional[torch.Tensor] = None,
               follow: Optional[torch.Tensor] = None, tie: float = 0.0):
    """From the latent: (prediction (B, out), perplexity, VQ loss, ids, tie
    margins); ``ids``, ``follow`` and ``tie`` as :func:`quantize` takes them."""
    vq_loss, q, perp, ids, margin = quantize(z, p["rir_model._vq._embedding.weight"], memory_order=False, ids=ids,
                                             follow=follow, tie=tie)
    h = q.transpose(1, 2).reshape(q.shape[0], -1)
    n = len(cfg["head"]["hidden"]) + 1
    for i in range(1, n + 1):
        h = linear(h, p[f"head.fc_{i}.weight"], p[f"head.fc_{i}.bias"])
        if i < n:
            h = F.relu(h)
    return h, perp, vq_loss, ids, margin


def joint_loss(p: Params, cfg: dict, batch: dict, follow=None, tie: float = 0.0):
    """``JointLocationTask(predict_radius=True, tail_weight=...)``'s loss:
    the (sin, cos) angle MSE, the commitment term, the tail of the worst
    per-sample errors and the radius MSE. ``follow`` (by branch), ``tie``:
    as :func:`quantize` takes them."""
    opt = cfg["loss"]
    pred, perp, vq_loss, ids, margin = joint_head(p, cfg, joint_latent(p, cfg, batch["echoed_spec"]),
                                                  follow=(follow or {}).get("rir"), tie=tie)
    theta = batch["theta"].reshape(-1, 1).to(pred.dtype)
    target = torch.cat([torch.sin(theta), torch.cos(theta)], dim=1)
    per_sample = ((pred[:, :-1] - target) ** 2).mean(dim=1)
    loss = per_sample.mean() + opt["commitment_weight"] * vq_loss
    if opt["tail_weight"]:
        k = max(1, math.ceil(per_sample.shape[0] * opt["tail_frac"]))
        loss = loss + opt["tail_weight"] * torch.topk(per_sample, k).values.mean()
    loss = loss + opt["radius_weight"] * ((pred[:, -1] - batch["radius"].to(pred.dtype)) ** 2).mean()
    return loss, {"rir_perplexity": perp.detach(), "codes": {"rir": (ids, margin)}}


def _answer(pred: torch.Tensor, geometry: dict):
    theta = torch.atan2(pred[:, 0], pred[:, 1])
    radius = pred[:, -1]
    receiver = torch.tensor(geometry["receiver_position"], dtype=pred.dtype, device=pred.device)
    room = torch.tensor(geometry["room_dimensions"], dtype=pred.dtype, device=pred.device)
    offs = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                        torch.full_like(theta, geometry["Z_LOC_SOURCE"])], dim=-1)
    return theta, radius, torch.minimum(receiver + offs, room)


def serve(p: Params, cfg: dict, geometry: dict, echoed_spec: torch.Tensor, codes: Optional[torch.Tensor] = None):
    """The served answer of each row, (theta rad, radius m, coords m (B, 3)),
    with its ids (B, R) and their tie margins (B, R), and the answer from
    ``codes`` (B, R) in place of the nearest ones (the reference's own
    answer where ``codes`` is None)."""
    z = joint_latent(p, cfg, echoed_spec)
    pred, _, _, ids, margin = joint_head(p, cfg, z)
    own = _answer(pred, geometry)
    from_codes = own if codes is None else _answer(joint_head(p, cfg, z, codes)[0], geometry)
    return own, ids, margin, from_codes


# ------------------------------------------------------------------- training


class Adam:
    """torch's Adam update written out: betas (0.9, 0.999), eps 1e-8 added
    outside the square root, bias-corrected; parameters without a gradient
    are left as they are."""

    def __init__(self, params: Params, trained: List[str], lr: float):
        self.params, self.trained, self.lr, self.t = params, trained, lr, 0
        self.m = {k: torch.zeros_like(params[k]) for k in trained}
        self.v = {k: torch.zeros_like(params[k]) for k in trained}

    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in self.trained:
            g = grads.get(k)
            if g is None:
                continue
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)) + 1e-8
            self.params[k].data.addcdiv_(self.m[k], denom, value=-self.lr / c1)
