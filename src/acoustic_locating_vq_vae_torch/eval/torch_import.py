"""Load the reference's PyTorch checkpoints into the port's modules.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/torch_import.py:38-165``.
The reference's checkpoints are whole pickled modules (its inter-stage API,
train_echoed_speech.py:18-19, train_location.py:38) or, through the JAX
package's ``eval/torch_export.py``, state dicts with the reference's keys.
The port's modules carry those keys and the reference's layouts (conv
``(out, in, k)``, ``ConvTranspose1d`` ``(in, out, k)``, linear ``(out,
in)``), so a state dict comes across as it is, with two things to get right:

* **The shapes say the model.** :func:`vqvae_config` reads the widths, the
  residual depth and the codebook size from the tensors, and the build functions
  (:func:`build_vqvae`, :func:`build_echoed`, :func:`build_location`) make a
  module of that size.
* **Tied stacks.** The reference's residual stack is one module at every
  index (residual_stack.py:40-41), so its state dict holds N identical
  per-layer tensors; a stack trained untied holds N different ones.
  :func:`stack_layout` tells them apart, and the build functions tie a stack only
  where its layers are equal. A tied port stack registers its one block at
  every index, so ``load_state_dict`` of an untied checkpoint into it would
  keep the last layer's tensors and drop the others without an error:
  :func:`load_reference_state` refuses that.

``vqvae_params``, ``decoder_params``, ``echoed_params`` and
``location_params`` return the port's state dicts (float32, on the CPU) for
``load_reference_state`` into a module of the right build (a task's
``build_model`` ties its stacks).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.conv_vqvae import ConvolutionalVQVAE
from ..models.echoed_speech import EchoedSpeechReconModel
from ..models.location import LocationModule
from ..ops.residual import ResidualStack

__all__ = [
    "build_echoed", "build_location", "build_vqvae", "decoder_params", "echoed_params",
    "load_reference_state", "location_params", "stack_layout", "torch_state_dict", "vqvae_config",
    "vqvae_params",
]

StateDict = Dict[str, torch.Tensor]


def torch_state_dict(obj: Any) -> StateDict:
    """``{key: float32 CPU tensor}`` from a live ``nn.Module``, a state dict
    (tensors or arrays), or a path to a ``torch.save`` file: a state dict or
    tensor bundle loads with ``weights_only=True``; a whole-module pickle
    (the reference's own format) needs the reference package importable and
    loads with ``weights_only=False``."""
    if isinstance(obj, str):
        try:
            loaded = torch.load(obj, map_location="cpu", weights_only=True)
        except Exception:  # a pickled module: its classes come from the reference package
            loaded = torch.load(obj, map_location="cpu", weights_only=False)
        return torch_state_dict(loaded)
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        obj = obj.state_dict()
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).clone() for k, v in dict(obj).items()}


def _sub(sd: StateDict, prefix: str) -> StateDict:
    """The entries under ``prefix.``, with the prefix taken off."""
    if not prefix:
        return dict(sd)
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def stack_layout(sd: StateDict, prefix: str) -> Tuple[int, bool]:
    """``(layers, tied)`` of the residual stack under ``prefix``: the count
    of ``_layers.<i>`` entries, and whether every layer's tensors equal the
    first's."""
    n = 0
    while f"{prefix}._layers.{n}._block.1.weight" in sd:
        n += 1
    if n == 0:
        raise KeyError(f"no residual layers under {prefix!r}")
    tied = all(
        torch.equal(sd[f"{prefix}._layers.{i}._block.{j}.weight"], sd[f"{prefix}._layers.0._block.{j}.weight"])
        for i in range(n) for j in (1, 3)
    )
    return n, tied


def vqvae_params(checkpoint: Any, prefix: str = "") -> StateDict:
    """The port's ``ConvolutionalVQVAE`` state dict of a reference
    ``ConvolutionalVQVAE`` (convolutional_vq_vae.py:18-105): a module, state
    dict or pickle path, its entries under ``prefix`` (e.g. ``rir_model``)."""
    sd = _sub(torch_state_dict(checkpoint), prefix)
    keep = ("_encoder.", "_pre_vq_conv.", "_vq._embedding.weight", "_decoder.")
    return {k: v for k, v in sd.items() if k.startswith(keep)}


def decoder_params(checkpoint: Any, prefix: str = "_decoder") -> StateDict:
    """The port's ``DeconvolutionalDecoder`` state dict of a reference
    decoder's entries under ``prefix`` (deconvolutional_decoder.py)."""
    return _sub(torch_state_dict(checkpoint), prefix)


def echoed_params(checkpoint: Any) -> StateDict:
    """The port's ``EchoedSpeechReconModel`` state dict of a reference
    composite (echoed_speech_model.py:9-56): both branches under their
    attribute names and the composite decoder."""
    sd = torch_state_dict(checkpoint)
    out = {f"{name}.{k}": v for name in ("rir_model", "speech_model") for k, v in vqvae_params(sd, name).items()}
    out.update({f"_decoder.{k}": v for k, v in decoder_params(sd).items()})
    return out


def location_params(checkpoint: Any) -> StateDict:
    """The port's ``LocationModule`` state dict of the reference MLP
    (location_model.py:5-29)."""
    sd = torch_state_dict(checkpoint)
    return {f"fc_{i}.{p}": sd[f"fc_{i}.{p}"] for i in (1, 2, 3, 4, 5) for p in ("weight", "bias")}


def _decoder_config(sd: StateDict, prefix: str) -> dict:
    layers, tied = stack_layout(sd, f"{prefix}._residual_stack")
    return dict(
        in_channels=sd[f"{prefix}._conv_1.weight"].shape[1],
        out_channels=sd[f"{prefix}._conv_trans_3.weight"].shape[1],  # ConvTranspose1d: (in, out, k)
        num_hiddens=sd[f"{prefix}._conv_1.weight"].shape[0],
        num_residual_layers=layers,
        num_residual_hiddens=sd[f"{prefix}._residual_stack._layers.0._block.1.weight"].shape[0],
        tied=tied,
    )


def vqvae_config(sd: StateDict) -> dict:
    """``ConvolutionalVQVAE`` arguments read from a state dict's shapes: the
    widths, the residual depth, the codebook, whether there is a decoder and
    whether the stacks are tied (both, else neither). The options no shape
    shows (the VQ flatten, jitter, the EMA codebook, the compute dtype) are
    the build function's keywords."""
    layers, tied = stack_layout(sd, "_encoder._residual_stack")
    cfg = dict(
        in_channels=sd["_encoder._conv_1.weight"].shape[1],
        num_hiddens=sd["_encoder._conv_1.weight"].shape[0],
        embedding_dim=sd["_pre_vq_conv.weight"].shape[0],
        num_residual_layers=layers,
        num_residual_hiddens=sd["_encoder._residual_stack._layers.0._block.1.weight"].shape[0],
        num_embeddings=sd["_vq._embedding.weight"].shape[0],
        decoder="_decoder._conv_1.weight" in sd,
        tied=tied,
    )
    if cfg["decoder"]:
        dec = _decoder_config(sd, "_decoder")
        if dec["num_residual_layers"] != layers:
            raise ValueError(f"encoder and decoder stacks have {layers} and {dec['num_residual_layers']} layers; "
                             "ConvolutionalVQVAE builds both with one depth")
        cfg.update(out_channels=dec["out_channels"], tied=tied and dec["tied"])
    return cfg


def _check_ties(module: torch.nn.Module, state_dict: StateDict) -> None:
    """Raise where a tied stack of ``module`` would receive layers that
    differ (it would keep the last one's)."""
    for name, m in module.named_modules():
        if isinstance(m, ResidualStack) and len(m._layers) > 1 and m._layers[0] is m._layers[1]:
            try:
                _, tied = stack_layout(state_dict, name)
            except KeyError:
                continue  # strict loading reports the missing keys
            if not tied:
                raise ValueError(f"{name}: the checkpoint's residual layers differ, but the module ties them and "
                                 "would keep only the last; build it untied (eval.torch_import.build_vqvae)")


def load_reference_state(module: torch.nn.Module, state_dict: StateDict) -> torch.nn.Module:
    """``module.load_state_dict(state_dict, strict=True)``, refused where a
    tied stack of ``module`` would receive layers that differ."""
    _check_ties(module, state_dict)
    module.load_state_dict(state_dict, strict=True)
    return module


def build_vqvae(checkpoint: Any, prefix: str = "", **kwargs) -> ConvolutionalVQVAE:
    """A ``ConvolutionalVQVAE`` of the checkpoint's size and tying
    (:func:`vqvae_config`) holding its weights; ``kwargs`` set what no shape
    shows (``compat_vq_flatten``, ``use_jitter``, ``compute_dtype``, ...)."""
    sd = vqvae_params(checkpoint, prefix)
    with torch.device("meta"):
        model = ConvolutionalVQVAE(commitment_cost=kwargs.pop("commitment_cost", 0.25), **vqvae_config(sd), **kwargs)
    return _assign(model, sd)


def build_echoed(checkpoint: Any, **kwargs) -> EchoedSpeechReconModel:
    """An ``EchoedSpeechReconModel`` of the checkpoint's branches and
    decoder; ``kwargs`` go to both branches (``compat_vq_flatten``, ...)."""
    sd = torch_state_dict(checkpoint)
    rir = build_vqvae(sd, "rir_model", use_jitter=False, **kwargs)
    speech = build_vqvae(sd, "speech_model", **kwargs)
    dec = _decoder_config(sd, "_decoder")
    dec.pop("in_channels")
    with torch.device("meta"):
        model = EchoedSpeechReconModel(rir, speech, **dec, compute_dtype=kwargs.get("compute_dtype"))
    return _assign(model, echoed_params(sd))


def build_location(checkpoint: Any) -> LocationModule:
    """A ``LocationModule`` of the checkpoint's input and output widths."""
    sd = location_params(checkpoint)
    with torch.device("meta"):
        model = LocationModule(sd["fc_1.weight"].shape[1], 1, sd["fc_5.weight"].shape[0])
    return _assign(model, sd)


def _assign(model: torch.nn.Module, sd: StateDict) -> torch.nn.Module:
    """``model`` (built on the meta device) holding ``sd``'s tensors; a tied
    stack's one block takes them once per index, all equal."""
    _check_ties(model, sd)
    model.load_state_dict(sd, strict=True, assign=True)
    return model
