"""Sequence (time-axis) parallelism by halo exchange.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel/sequence.py:34-153``.
Every layer of this model family is a stride-1 conv with kernel <= 3, so the
time axis can be sharded over the ranks of the mesh's ``seq`` axis: before
each conv a rank sends its (k-1)/2 edge frames to each neighbour and receives
theirs ("halos"), then convolves VALID. That is O(B C) bytes per conv,
whatever the length, and equals the unsharded SAME conv. The port is
channels-first, so time is the last dim of ``(B, C, L)``.

* :func:`halo_exchange` is an autograd function: the forward prepends the
  left neighbour's last frames and appends the right neighbour's first ones
  (zeros at the two ends of the chain, the global conv's zero padding); the
  backward sends each halo's gradient back to the neighbour it came from,
  which adds it to its edge frames (JAX gets that from ``ppermute``'s
  transpose).
* How the frames travel follows the subgroup's backend, never a caught
  error: NCCL, and gloo with CPU tensors, exchange point to point
  (``dist.batch_isend_irecv``, each rank with its two neighbours); gloo with
  CUDA tensors sums a zero-filled ``(n, 2, ...)`` buffer in which each rank
  writes its two edges (adding zeros is exact; a sum is the collective every
  backend has for every device). ``HALO_PATHS`` counts the exchanges by path.
* :func:`seq_all_gather` and :func:`seq_pmean` are the other two collectives
  a sharded model runs (the echoed composite's RIR branch reads the whole time
  extent; a mean over time); :func:`global_value` reports a rank's local
  loss as the global mean while its gradient stays local.

The gradient convention: each rank of a seq group computes its loss on its
own time shard and backpropagates it; the gradients of the replicated
parameters are then averaged over the group (``parallel/dp_step.py``), which
is the JAX ``shard_map`` transpose of a ``pmean``'d loss.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = [
    "HALO_PATHS", "global_value", "halo_exchange", "seq_all_gather", "seq_pmean", "sequence_parallel_apply",
    "sequence_sharded_conv", "sharded_conv1d",
]

# exchanges made, by path: "p2p" (batch_isend_irecv) or "summed" (a zero-filled buffer summed over the group)
HALO_PATHS: collections.Counter = collections.Counter()


def _axis(mesh, axis: str):
    """(subgroup, coordinate, size) of ``axis`` on ``mesh``; a world of one
    without a mesh."""
    if mesh is None:
        return None, 0, 1
    return mesh.axis(axis)


def point_to_point(group, device: torch.device) -> bool:
    """Whether halos travel point to point on ``group`` for tensors on
    ``device``: under NCCL, and under gloo for CPU tensors; gloo's CUDA
    tensors go through a summed buffer instead."""
    backend = dist.get_backend(group)
    return backend == "nccl" or (backend == "gloo" and device.type == "cpu")


def _exchange(left: torch.Tensor, right: torch.Tensor, mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``left`` to the left neighbour and ``right`` to the right one on
    ``axis``; return (the left neighbour's ``right``, the right neighbour's
    ``left``), zeros at the two ends of the chain."""
    group, s, n = _axis(mesh, axis)
    from_left, from_right = torch.zeros_like(right), torch.zeros_like(left)
    if group is None or n == 1:
        return from_left, from_right
    if point_to_point(group, left.device):
        ops = []
        left, right = left.contiguous(), right.contiguous()
        if s > 0:
            peer = mesh.peer(axis, s - 1)
            ops += [dist.P2POp(dist.isend, left, peer, group), dist.P2POp(dist.irecv, from_left, peer, group)]
        if s < n - 1:
            peer = mesh.peer(axis, s + 1)
            ops += [dist.P2POp(dist.isend, right, peer, group), dist.P2POp(dist.irecv, from_right, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        HALO_PATHS["p2p"] += 1
        return from_left, from_right
    buf = torch.zeros((n, 2, *left.shape), dtype=left.dtype, device=left.device)
    buf[s, 0] = left
    buf[s, 1] = right
    dist.all_reduce(buf, group=group)
    HALO_PATHS["summed"] += 1
    if s > 0:
        from_left = buf[s - 1, 1]
    if s < n - 1:
        from_right = buf[s + 1, 0]
    return from_left, from_right


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo: int, mesh, axis: str):
        ctx.halo, ctx.mesh, ctx.axis = halo, mesh, axis
        from_left, from_right = _exchange(x[..., :halo], x[..., -halo:], mesh, axis)
        return torch.cat([from_left, x, from_right], dim=-1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        # the gradient of each halo goes back to the neighbour whose edge it was
        from_left, from_right = _exchange(g[..., :h], g[..., -h:], ctx.mesh, ctx.axis)
        gx = g[..., h:-h].clone()
        gx[..., :h] += from_left
        gx[..., -h:] += from_right
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, mesh, axis: str = "seq") -> torch.Tensor:
    """``x`` (..., L_local) with the left neighbour's last ``halo`` frames
    prepended and the right neighbour's first ``halo`` frames appended on the
    mesh's ``axis``: (..., L_local + 2 halo), zeros at the ends of the chain
    (the global conv's zero padding). Without a mesh, or on an axis of one
    rank, the zero padding alone. Differentiable."""
    if halo <= 0:
        return x
    if halo > x.shape[-1]:
        raise ValueError(f"a halo of {halo} frames needs at least {halo} frames a shard, got {x.shape[-1]}")
    if _axis(mesh, axis)[2] == 1:
        return F.pad(x, (halo, halo))
    return _Halo.apply(x, halo, mesh, axis)


def sharded_conv1d(x: torch.Tensor, weight: torch.Tensor, mesh, bias: Optional[torch.Tensor] = None,
                   axis: str = "seq") -> torch.Tensor:
    """The SAME stride-1 conv over a time shard ``x`` (B, C_in, L_local):
    ``weight`` (C_out, C_in, k), k odd. A halo exchange of (k-1)/2 frames,
    then a VALID conv: equal to the shard of the unsharded conv of the
    concatenated sequence."""
    k = weight.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"a sharded conv needs an odd kernel, got {k}")
    return F.conv1d(halo_exchange(x, (k - 1) // 2, mesh, axis), weight, bias)


def _local_slice(length: int, mesh, axis: str) -> slice:
    _, s, n = _axis(mesh, axis)
    if length % n:
        raise ValueError(f"sequence length {length} not divisible by {axis}={n}")
    per = length // n
    return slice(s * per, (s + 1) * per)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis: str, dim: int):
        ctx.mesh, ctx.axis, ctx.dim, ctx.length = mesh, axis, dim, x.shape[dim]
        rows = mesh.gather_rows(x.contiguous(), axis)  # (n, *x.shape)
        return torch.cat(rows.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the whole gathered tensor: a shard's gradient is the sum over the ranks
        g = ctx.mesh.all_reduce_(g.contiguous().clone(), axis=ctx.axis)
        s = ctx.mesh.axis(ctx.axis)[1]
        return g.narrow(ctx.dim, s * ctx.length, ctx.length), None, None, None


def seq_all_gather(x: torch.Tensor, mesh, axis: str = "seq", dim: int = -1) -> torch.Tensor:
    """Every rank's time shard ``x`` laid end to end along ``dim``, on every
    rank of ``axis`` (the identity on an axis of one rank). The backward sums
    the gradient over the ranks and keeps the rank's own shard."""
    if _axis(mesh, axis)[2] == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        n = mesh.axis(axis)[2]
        return mesh.all_reduce_(x.detach().clone(), axis=axis) / n

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis(ctx.axis)[2]
        return ctx.mesh.all_reduce_(g.contiguous().clone(), axis=ctx.axis) / n, None, None


def seq_pmean(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (the JAX ``pmean``),
    differentiable: the backward is the mean of the ranks' gradients."""
    if _axis(mesh, axis)[2] == 1:
        return x
    return _PMean.apply(x, mesh, axis)


def global_value(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """``x`` whose value is its mean over the ranks of ``axis`` and whose
    gradient is ``x``'s own: a rank's local loss reported as the global one,
    under the convention that gradients are averaged over the axis later."""
    if _axis(mesh, axis)[2] == 1:
        return x
    with torch.no_grad():
        mean = mesh.all_reduce_(x.detach().clone(), axis=axis) / mesh.axis(axis)[2]
    return x + (mean - x).detach()


def sequence_sharded_conv(x: torch.Tensor, weight: torch.Tensor, mesh, bias: Optional[torch.Tensor] = None,
                          axis: str = "seq") -> torch.Tensor:
    """The SAME stride-1 conv of ``x`` (B, C_in, L), every rank holding the
    whole ``x``, with the time axis sharded over ``axis``: each rank convolves
    its shard with halos and the shards are gathered back, so the result is
    the unsharded conv's on every rank; the only cross-rank traffic of the
    conv itself is the (k-1)-frame halo. L must divide by the axis size."""
    part = x[..., _local_slice(x.shape[-1], mesh, axis)]
    return seq_all_gather(sharded_conv1d(part, weight, mesh, bias, axis), mesh, axis)


def sequence_parallel_apply(model, x: torch.Tensor, mesh, axis: str = "seq", train: bool = False,
                            generator: Optional[torch.Generator] = None):
    """Apply a ``ConvolutionalVQVAE`` built with ``sequence_axis=axis`` to
    ``x`` (B, C, L), every rank holding the whole ``x``, with the time axis
    sharded over ``axis``: every conv exchanges its halo, the quantizer
    reduces its code counts and EMA statistics over the axis, and the jitter
    reads the one global draw of decisions from ``generator`` with a 1-frame
    halo. Returns ``(vq_loss, recon, perplexity)``: the loss and perplexity
    the replicated model's (the loss's gradient this rank's share, see the
    module docstring), ``recon`` this rank's time shard (B, C_out, L / n)."""
    from ..models.conv_vqvae import sequence_sharding

    if getattr(model, "sequence_axis", None) != axis:
        raise ValueError(f"model.sequence_axis={getattr(model, 'sequence_axis', None)!r} must equal axis={axis!r}")
    part = x[..., _local_slice(x.shape[-1], mesh, axis)]
    with sequence_sharding(model, mesh):
        vq_loss, recon, perplexity = model(part, train=train, generator=generator)
    return global_value(vq_loss, mesh, axis), recon, perplexity
