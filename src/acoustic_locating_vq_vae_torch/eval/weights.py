"""Carry trained weights from the JAX package's flax parameter trees into the
port's modules.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/torch_export.py:36-132``,
with the port's own key names (which are the reference's). The tree comes in
as nested dicts of arrays (numpy, or anything ``np.asarray`` takes); nothing
of JAX is imported. Layout changes:

  * flax conv kernel (k, in, out) -> torch conv weight (out, in, k);
  * the JAX stride-1 transposed conv, a plain conv with its own kernel
    (k, in, out) -> torch ConvTranspose1d weight (in, out, k), flipped along
    k (``torch_export.py:41-44`` ``_t_transposed``);
  * flax dense kernel (in, out) -> torch linear weight (out, in);
  * the tied residual block is copied to every layer index, as the
    reference's shared-instance ModuleList stores it;
  * the codebook comes from ``_vq/codebook``, or for an EMA model from its
    ``vq_stats`` collection, with the EMA counts and sums.

The maps are linear, so a gradient tree of the same structure comes across
the same way, and so does the split dim of a partition spec
(:func:`partition_specs_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "composite_params_from_jax", "partition_specs_from_jax"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _conv(tree, name: str, out: Dict[str, torch.Tensor], transposed: bool = False) -> None:
    sub = tree["Conv_0"]
    kernel = np.asarray(sub["kernel"])
    out[f"{name}.weight"] = _tensor(kernel[::-1].transpose(1, 2, 0) if transposed else kernel.transpose(2, 1, 0))
    if "bias" in sub:
        out[f"{name}.bias"] = _tensor(sub["bias"])


def _stack(tree, prefix: str, num_layers: int, out: Dict[str, torch.Tensor]) -> None:
    if "residual" in tree:  # tied: one block at every index
        blocks = [tree["residual"]] * num_layers
    else:
        blocks = [tree[f"residual_{i}"] for i in range(num_layers)]
    for i, b in enumerate(blocks):
        base = _key(prefix, f"_layers.{i}._block")
        # Sequential(relu, conv_1, relu, conv_2): convs at indices 1 and 3
        _conv(b["conv_1"], f"{base}.1", out)
        _conv(b["conv_2"], f"{base}.3", out)


def _encoder(tree, prefix: str, num_layers: int, out: Dict[str, torch.Tensor]) -> None:
    _conv(tree["conv_1"], _key(prefix, "_conv_1"), out)
    _stack(tree["residual_stack"], _key(prefix, "_residual_stack"), num_layers, out)


def _decoder(tree, prefix: str, num_layers: int, out: Dict[str, torch.Tensor]) -> None:
    _conv(tree["conv_1"], _key(prefix, "_conv_1"), out)
    _stack(tree["residual_stack"], _key(prefix, "_residual_stack"), num_layers, out)
    for i in (1, 2, 3):
        _conv(tree[f"conv_trans_{i}"], _key(prefix, f"_conv_trans_{i}"), out, transposed=True)


def _vqvae(tree, prefix: str, num_layers: int, out: Dict[str, torch.Tensor], vq_stats=None, decoder: bool = True) -> None:
    """Encoder, pre-VQ conv, codebook and, when the tree has one and
    ``decoder`` is true, the decoder."""
    _encoder(tree["_encoder"], _key(prefix, "_encoder"), num_layers, out)
    _conv(tree["_pre_vq_conv"], _key(prefix, "_pre_vq_conv"), out)
    if vq_stats is not None:
        stats = vq_stats["_vq"]
        out[_key(prefix, "_vq._embedding.weight")] = _tensor(stats["codebook"])
        out[_key(prefix, "_vq.ema_counts")] = _tensor(stats["ema_counts"])
        out[_key(prefix, "_vq.ema_sums")] = _tensor(stats["ema_sums"])
    else:
        out[_key(prefix, "_vq._embedding.weight")] = _tensor(tree["_vq"]["codebook"])
    if decoder and "_decoder" in tree:
        _decoder(tree["_decoder"], _key(prefix, "_decoder"), num_layers, out)


def _location(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for i in (1, 2, 3, 4, 5):
        sub = tree[f"fc_{i}"]["Dense_0"]
        out[_key(prefix, f"fc_{i}.weight")] = _tensor(np.asarray(sub["kernel"]).T)
        out[_key(prefix, f"fc_{i}.bias")] = _tensor(sub["bias"])


def params_from_jax(tree: Any, num_residual_layers: int = 2, vq_stats: Any = None) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax ``params`` tree of the JAX package.

    The tree's top-level names say which model it is:

    * ``rir_model`` and ``head``: ``JointLocationModel``;
    * ``rir_model`` alone (an ``EchoedSpeechReconModel`` composite): its RIR
      branch as an encode-only ``ConvolutionalVQVAE``, for the frozen
      localizer; the speech branch and the decoders are not read;
    * ``_encoder``: ``ConvolutionalVQVAE``, with its decoder when the tree
      has one;
    * ``fc_1``: ``LocationModule``;
    * ``conv_trans_1``: ``DeconvolutionalDecoder``;
    * ``conv_1`` and ``residual_stack``: ``ConvolutionalEncoder``.

    ``num_residual_layers`` is the stack depth the tied block is copied to
    (2 in both localizers' RIR branch and the RIR stage, 3 in the speech
    stage). ``vq_stats`` is an EMA model's ``vq_stats`` collection (its
    codebook lives there, not in ``params``).
    """
    out: Dict[str, torch.Tensor] = {}
    if "rir_model" in tree and "head" in tree:
        _vqvae(tree["rir_model"], "rir_model", num_residual_layers, out)
        _location(tree["head"], "head", out)
    elif "rir_model" in tree:
        _vqvae(tree["rir_model"], "", num_residual_layers, out, decoder=False)
    elif "_encoder" in tree:
        _vqvae(tree, "", num_residual_layers, out, vq_stats)
    elif "fc_1" in tree:
        _location(tree, "", out)
    elif "conv_trans_1" in tree:
        _decoder(tree, "", num_residual_layers, out)
    elif "conv_1" in tree and "residual_stack" in tree:
        _encoder(tree, "", num_residual_layers, out)
    else:
        raise ValueError(f"unrecognised parameter tree with top-level names {sorted(tree)}")
    return out


def composite_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """The port's state dict for the flax ``params`` tree of an
    ``EchoedSpeechReconModel`` (the JAX ``echoed_state_dict``,
    torch_export.py:108-122): both branches under ``rir_model.`` and
    ``speech_model.``, each with the depth of its stage (2 and 3), and the
    composite decoder under ``_decoder.`` (2). A branch carries its decoder
    where the tree has one, as a composite grafted from the speech and RIR
    stages does; a freshly initialised composite has none, flax making no
    parameters for a submodule it never called.

    ``params_from_jax`` reads the same tree as the frozen localizer's RIR
    branch alone."""
    out: Dict[str, torch.Tensor] = {}
    _vqvae(tree["rir_model"], "rir_model", 2, out)
    _vqvae(tree["speech_model"], "speech_model", 3, out)
    _decoder(tree["_decoder"], "_decoder", 2, out)
    return out


def partition_specs_from_jax(specs: Any, num_residual_layers: int = 2, composite: bool = False) -> Dict[str, tuple]:
    """The port's partition spec of every parameter (``parallel.sharding_rules``'
    form: ``"model"`` at the split dim of the torch layout, or ``()``) from a
    tree of the JAX package's, one per flax parameter, each written out to
    the parameter's rank (``(None, None, "model")``, ``(None, None, None)``).
    Each spec becomes an array of ones with a 2 at its split dim, which goes
    through :func:`params_from_jax` (``composite``: :func:`composite_params_from_jax`)
    as a weight would, so the split dim lands where the layout changes put
    it."""

    def indicator(spec) -> np.ndarray:
        return np.ones(tuple(2 if axis == "model" else 1 for axis in spec), np.float32)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return indicator(tree)

    arrays = walk(specs)
    out = composite_params_from_jax(arrays) if composite else params_from_jax(arrays, num_residual_layers)
    return {k: (tuple("model" if n == 2 else None for n in v.shape) if 2 in v.shape else ()) for k, v in out.items()}
