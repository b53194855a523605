"""Configuration ``joint_localizer``: run K's joint localizer
(``JointLocationTask(predict_radius=True)``, the model ``export_localizer``
ships): the RIR conv VQ-VAE encoder over frequency with channel-vector
flatten, its quantized latent into the dense head (sin, cos, radius), served
as (angle, radius, position).

The harness loads this module by the configuration's name; see
``echoed_composite.py``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from harness import flops
from reference import model as ref

QUANTIZERS = {"rir": "rir_model._vq"}


def build(cfg: dict, geo, width_scale: float):
    """The program's ``JointLocationTask`` of the configuration."""
    from acoustic_locating_vq_vae_torch.train.tasks import JointLocationTask

    loss_cfg = cfg["loss"]
    return JointLocationTask(config=geo, width_scale=width_scale, batch_size=cfg["train_batch"],
                             learning_rate=cfg["learning_rate"], predict_radius=True,
                             commitment_weight=loss_cfg["commitment_weight"], tail_weight=loss_cfg["tail_weight"],
                             tail_frac=loss_cfg["tail_frac"], radius_weight=loss_cfg["radius_weight"])


def _widths(cfg: dict) -> List[int]:
    return [cfg["head"]["in_rows"] * cfg["rir"]["embedding_dim"]] + cfg["head"]["hidden"] + [cfg["head"]["out"]]


def param_spec(cfg: dict):
    """``(key, shape, init, fan_in)`` of every state-dict entry."""
    spec = ref.vqvae_spec("rir_model.", cfg["rir"], decoder=False)
    widths = _widths(cfg)
    for i in range(len(widths) - 1):
        p = f"head.fc_{i + 1}."
        spec += [(p + "weight", (widths[i + 1], widths[i]), "default", widths[i]),
                 (p + "bias", (widths[i + 1],), "default", widths[i])]
    return spec


def codebook_inputs(cfg: dict, x: torch.Tensor):
    return [("rir_model.", cfg["rir"], x.transpose(1, 2), False)]


def counts(cfg: dict, kind: str, batch: int) -> Dict:
    """FLOPs of one served call (``serve``: the encoder, the assignment's
    cross term and the head, forward) of ``batch`` rows."""
    if kind != "serve":
        raise ValueError(f"no {kind!r} count for {__name__}")
    bins, rr = cfg["geometry"]["NFFT"] // 2 + 1, cfg["rir"]
    conv = sum(flops.encoder_layers(batch, bins, rr))
    head = flops.dense_flops(batch, _widths(cfg))
    return {"model": conv + head + flops.vq_flops(batch * bins, rr), "conv": conv,
            "vq_calls": [(batch * bins, rr["embedding_dim"], rr["num_embeddings"])]}


def answers(p, cfg: dict, geometry: dict, echoed_spec: torch.Tensor, codes=None):
    """The reference's served answers ``(theta, radius, coords)``, its codes,
    their tie margins, and the answers from ``codes`` (B, R) in place of its
    own (its own answers where ``codes`` is None)."""
    return ref.serve(p, cfg, geometry, echoed_spec, codes)
