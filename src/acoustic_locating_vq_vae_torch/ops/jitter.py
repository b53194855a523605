"""Chorowski-2019 latent jitter (reference: vq_vae/modules/jitter.py:31-70).

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/jitter.py:27-53`` (``jitter``)
and ``:102-117`` (``Jitter``); the time-sharded variant waits for the port's
``parallel/``. Semantics:

* ``replace ~ Bernoulli(p)`` per time step, shared across the batch (the
  reference's default; ``per_batch=True`` draws per sample);
* direction +-1 uniform, the two ends clamped to their single neighbour;
* replaced slots carry no gradient (the reference copies from
  ``quantized.detach()``, jitter.py:47-53).

The port is channels-first, so time is the LAST dim of ``(B, D, L)`` here (the
JAX package jitters axis 1 of ``(B, L, D)``). The decisions come from an
explicit CPU ``torch.Generator`` (:func:`jitter_decisions`) and are moved to
the latent's device, so a run on the card and one on the CPU with the same
generator state jitter alike; :func:`jitter` takes the decisions, so tests
can feed both packages the same ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["Jitter", "jitter", "jitter_decisions"]


def jitter_decisions(
    shape: Tuple[int, ...], probability: float, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(replace, forward) bool masks of ``shape``: ``(L,)`` batch-shared or
    ``(B, L)`` per sample. ``forward`` picks the next step, else the previous."""
    replace = torch.rand(shape, generator=generator) < probability
    forward = torch.rand(shape, generator=generator) < 0.5
    return replace, forward


def jitter(x: torch.Tensor, replace: torch.Tensor, forward: torch.Tensor) -> torch.Tensor:
    """Jitter ``x`` (B, D, L) along its last dim with the given decisions,
    ``(L,)`` or ``(B, L)`` bool masks on any device."""
    length = x.shape[-1]
    replace = replace.to(x.device)
    forward = forward.to(x.device)
    pos = torch.arange(length, device=x.device).expand(replace.shape)
    neighbor = torch.where(forward, pos + 1, pos - 1)
    neighbor = torch.where(pos == 0, torch.ones_like(pos), neighbor)
    neighbor = torch.where(pos == length - 1, torch.full_like(pos, length - 2), neighbor)
    idx = torch.where(replace, neighbor, pos)
    source = x.detach()
    if replace.dim() == 1:
        return torch.where(replace, source[..., idx], x)
    gathered = torch.gather(source, -1, idx[:, None, :].expand_as(x))
    return torch.where(replace[:, None, :], gathered, x)


class Jitter(nn.Module):
    """Train-only latent jitter; a no-op when ``train`` is false or ``p <= 0``."""

    def __init__(self, probability: float = 0.12, per_batch: bool = False):
        super().__init__()
        self.probability = probability
        self.per_batch = per_batch

    def forward(
        self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if not train or self.probability <= 0.0:
            return x
        shape = (x.shape[0], x.shape[-1]) if self.per_batch else (x.shape[-1],)
        return jitter(x, *jitter_decisions(shape, self.probability, generator))
