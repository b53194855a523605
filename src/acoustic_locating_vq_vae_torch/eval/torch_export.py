"""Export the port's trained weights as PyTorch state dicts with the
reference's module naming, so weights can move back into the reference
implementation.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/torch_export.py``, which
makes these dicts from flax parameter trees; this module makes them from the
port's own modules or state dicts. The port's modules already carry the
reference's keys and layouts (conv ``(out, in, k)``, ``ConvTranspose1d``
``(in, out, k)``, linear ``(out, in)``), and a tied residual stack registers
its one block at every layer index, so its state dict already holds the
SAME tensors at every index, as the reference's shared-instance ModuleList
does (residual_stack.py:40-41). What the export does:

  * keeps the entries the reference modules have and drops the rest: an EMA
    quantizer's ``_vq.ema_counts`` and ``_vq.ema_sums``, which the reference
    lacks; its codebook, a buffer here, becomes ``_vq._embedding.weight``
    as any other;
  * returns each tensor contiguous, on the CPU and cloned, never a view into
    a live module.

The inverse is :mod:`.torch_import`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = [
    "vqvae_state_dict",
    "decoder_state_dict",
    "echoed_state_dict",
    "location_state_dict",
    "save_reference_state_dicts",
]

StateDict = Dict[str, torch.Tensor]
_VQVAE_PARTS = ("_encoder.", "_pre_vq_conv.", "_vq._embedding.weight", "_decoder.")


def _entries(params: Any, prefix: str) -> StateDict:
    """The entries of a module's or a state dict's ``prefix.`` subtree, the
    prefix taken off, each a contiguous CPU clone."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    p = f"{prefix}." if prefix else ""
    return {k[len(p):]: v.detach().to("cpu").contiguous().clone() for k, v in sd.items() if k.startswith(p)}


def vqvae_state_dict(params: Any, prefix: str = "") -> StateDict:
    """State dict for a reference ``ConvolutionalVQVAE`` from the port's
    ``ConvolutionalVQVAE`` (a module or its state dict; ``prefix``: its
    entries under, e.g., ``speech_model``). An EMA model's codebook is
    exported as the reference's ``_vq._embedding.weight``; an encode-only
    branch exports no decoder."""
    sd = _entries(params, prefix)
    out = {k: v for k, v in sd.items() if k.startswith(_VQVAE_PARTS)}
    if "_vq._embedding.weight" not in out:
        raise KeyError(f"no codebook ('_vq._embedding.weight') under {prefix!r}")
    return out


def decoder_state_dict(dec_params: Any, prefix: str = "_decoder") -> StateDict:
    """State dict for a standalone reference ``DeconvolutionalDecoder``
    (deconvolutional_decoder.py:7-79) from the port's decoder (a module or
    its state dict), its keys under ``prefix``."""
    p = f"{prefix}." if prefix else ""
    return {f"{p}{k}": v for k, v in _entries(dec_params, "").items()}


def echoed_state_dict(params: Any) -> StateDict:
    """State dict for the reference ``EchoedSpeechReconModel``
    (echoed_speech_model.py:9-56) from the port's composite: the two
    sub-VQ-VAEs under their attribute prefixes plus the composite decoder."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    out: StateDict = {}
    for name in ("rir_model", "speech_model"):
        out.update({f"{name}.{k}": v for k, v in vqvae_state_dict(sd, name).items()})
    out.update(decoder_state_dict(_entries(sd, "_decoder")))
    return out


def location_state_dict(params: Any) -> StateDict:
    """State dict for the reference ``LocationModule`` (location_model.py:10-18)
    from the port's (a module, e.g. a ``JointLocationModel``'s ``head``, or
    its state dict)."""
    sd = _entries(params, "")
    return {f"fc_{i}.{p}": sd[f"fc_{i}.{p}"] for i in (1, 2, 3, 4, 5) for p in ("weight", "bias")}


def save_reference_state_dicts(path: str, dicts: Dict[str, StateDict]) -> None:
    """torch.save a {model_name: state_dict} bundle (tensors)."""
    bundle = {name: {k: torch.as_tensor(v).detach().to("cpu").contiguous().clone() for k, v in sd.items()}
              for name, sd in dicts.items()}
    torch.save(bundle, path)
