"""Chorowski-2019 latent jitter (reference: vq_vae/modules/jitter.py:31-70).

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/jitter.py:27-53`` (``jitter``),
``:56-99`` (``jitter_sharded``) and ``:102-117`` (``Jitter``). Semantics:

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

On a time-sharded latent (``sequence_axis``, with the mesh that
``models.conv_vqvae.sequence_sharding`` installs) every rank draws the one
global set of decisions from the shared generator and applies its window of
them with a 1-frame halo from its neighbours (:func:`jitter_sharded`), so
the sharded jitter is bitwise the unsharded one. (JAX folds the shard index
into its key instead, drawing each shard's decisions apart.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["Jitter", "jitter", "jitter_decisions", "jitter_sharded"]


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


def jitter_sharded(x: torch.Tensor, replace: torch.Tensor, forward: torch.Tensor, mesh,
                   axis: str = "seq") -> torch.Tensor:
    """Jitter a time shard ``x`` (B, D, L_local) with its window of the
    global decisions, ``(L_local,)`` or ``(B, L_local)``: the neighbours
    across the shard's edges come by a 1-frame halo exchange on the mesh's
    ``axis``, and only the first and last frames of the whole sequence clamp
    to their single neighbour. Equal to :func:`jitter` of the whole sequence
    on the shard's window."""
    from ..parallel.sequence import halo_exchange

    _, s, n = mesh.axis(axis)
    length = x.shape[-1]
    replace, forward = replace.to(x.device), forward.to(x.device)
    source = halo_exchange(x.detach(), 1, mesh, axis)  # (B, D, L_local + 2)
    pos = torch.arange(1, length + 1, device=x.device).expand(replace.shape)  # positions in the haloed shard
    neighbor = torch.where(forward, pos + 1, pos - 1)
    gpos = s * length + pos - 1
    neighbor = torch.where(gpos == 0, pos + 1, neighbor)
    neighbor = torch.where(gpos == n * length - 1, pos - 1, neighbor)
    idx = torch.where(replace, neighbor, pos)
    if replace.dim() == 1:
        return torch.where(replace, source[..., idx], x)
    gathered = torch.gather(source, -1, idx[:, None, :].expand(x.shape[0], x.shape[1], length))
    return torch.where(replace[:, None, :], gathered, x)


class Jitter(nn.Module):
    """Train-only latent jitter; a no-op when ``train`` is false or ``p <= 0``.
    With ``sequence_axis`` and a mesh set (``mesh``), the sharded jitter."""

    mesh = None

    def __init__(self, probability: float = 0.12, per_batch: bool = False, sequence_axis: Optional[str] = None):
        super().__init__()
        self.probability = probability
        self.per_batch = per_batch
        self.sequence_axis = sequence_axis

    def forward(
        self, x: torch.Tensor, train: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if not train or self.probability <= 0.0:
            return x
        n = 1
        if self.sequence_axis is not None and self.mesh is not None:
            _, s, n = self.mesh.axis(self.sequence_axis)
        length = x.shape[-1]
        shape = (x.shape[0], length * n) if self.per_batch else (length * n,)
        replace, forward = jitter_decisions(shape, self.probability, generator)
        if n == 1:
            return jitter(x, replace, forward)
        window = slice(s * length, (s + 1) * length)
        return jitter_sharded(x, replace[..., window], forward[..., window], self.mesh, self.sequence_axis)
