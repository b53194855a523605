"""The weights of a configuration, made on the device from the seed.

One ``torch.rand`` call fills every tensor of the state dict (the
reference's keys, the configuration module's ``param_spec``), each slice scaled to
its layer's initialisation: kaiming-uniform convs, torch's default for
biases, 1x1 residual convs and dense layers. A tied residual layer's keys
name one tensor. Each codebook is then replaced by K pre-VQ latent rows of a
separate seeded batch, computed by the reference's encoder in float32 with
TF32 off, so the codes in use are spread as in a trained model (an untrained
U(+-1/K) codebook makes the assignment a lottery of near-ties).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference import model as ref


def make_params(config, cfg: dict, gen: torch.Generator, latent_batch: torch.Tensor) -> Dict[str, torch.Tensor]:
    """State dict of ``cfg``'s model on ``gen``'s device (float32), laid out
    by the configuration module ``config``. ``latent_batch``: echoed power spectrograms
    whose latents seed the codebooks."""
    spec = config.param_spec(cfg)
    own = [(k, shape, init, fan) for k, shape, init, fan in spec if ref.tied_source(k) == k]
    total = sum(math.prod(shape) for _, shape, _, _ in own)
    flat = torch.rand(total, generator=gen, device=gen.device) * 2.0 - 1.0
    params, at = {}, 0
    for key, shape, init, fan in own:
        n = math.prod(shape)
        bound = {"kaiming": math.sqrt(6.0 / fan), "default": 1.0 / math.sqrt(fan), "codebook": 1.0 / fan}[init]
        params[key] = (flat[at: at + n] * bound).reshape(shape)
        at += n
    for key, *_ in spec:
        params[key] = params[ref.tied_source(key)]
    _latent_codebooks(params, config.codebook_inputs(cfg, ref.znorm(latent_batch, dim=1)), gen)
    return params


def _latent_codebooks(params, branches, gen) -> None:
    with torch.no_grad():
        for prefix, br, xin, memory_order in branches:
            z = ref.pre_vq(params, prefix, xin, br["num_residual_layers"])
            d = z.shape[1]
            rows = z.reshape(-1, d) if memory_order else z.transpose(1, 2).reshape(-1, d)
            k = br["num_embeddings"]
            if rows.shape[0] < k:
                raise ValueError(f"{rows.shape[0]} latent rows cannot seed a codebook of {k}")
            pick = torch.randperm(rows.shape[0], generator=gen, device=gen.device)[:k]
            params[prefix + "_vq._embedding.weight"] = rows[pick].contiguous()
