"""The training step over the process mesh with explicit collectives.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel/dp_step.py:23-57``
(``shard_map`` + ``pmean``) and of the JAX trainer's sequence-sharded loss
(``train/loop.py:317-349``): each rank computes the mean loss of its rows (of
its time shard, on a sequence axis) and its backward, the gradients and the
scalar metrics are averaged over the data and sequence axes, then every rank
takes the same optimizer step. The data average is weighted by each data
coordinate's share of the global rows, so it is the global batch's mean also
where the blocks are unequal (with equal blocks the weight is
``1 / world_size``, the JAX ``pmean``); the sequence average is the plain
mean over equal time shards, the transpose of JAX's ``pmean``'d loss. The
model axis takes no part: every rank of a model group holds the same
gradient of a replicated parameter and its own block's gradient of a sharded
one (``parallel/tensor.py``), neither summed over the group.

The gradients are reduced as one flat buffer in one collective. Only
parameters that have a gradient take part: a frozen branch gets none, which
Adam skips, and a tied residual block is one parameter however many
indices name it. That is why the port does not wrap the model in
``DistributedDataParallel``, whose buckets expect every parameter to get a
gradient (``find_unused_parameters``) and register each tensor once per
module that holds it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple, Union

import torch

from ..utils.profiling import span
from .mesh import DataParallel

__all__ = ["global_rows", "make_dp_train_step", "reduce_gradients", "reduce_metrics", "step_weight"]

Weight = Union[float, torch.Tensor]


def global_rows(rows: int, dp: DataParallel, device: torch.device) -> torch.Tensor:
    """The rows of the global batch, a 0-d float64 tensor on ``device`` (a
    sum over the ranks, which does not wait for the device)."""
    return dp.all_reduce_(torch.tensor(float(rows), dtype=torch.float64, device=device))


def step_weight(rows: int, dp: DataParallel, device: torch.device) -> Weight:
    """This rank's weight in the step's sums: its share of the global rows
    over the data axis, divided by the sequence axis's size (1.0 without a
    mesh)."""
    if not dp.distributed:
        return 1.0
    weight = rows / global_rows(rows, dp, device)
    return weight / dp.seq_size if dp.seq_size > 1 else weight


def _sum_over_mesh(flat: torch.Tensor, dp: DataParallel) -> None:
    dp.all_reduce_(flat)
    dp.all_reduce_(flat, axis="seq")


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.Tensor], dp: DataParallel, weight: Weight) -> None:
    """Replace each ``p.grad`` by the sum over the data and sequence axes of
    ``weight * p.grad`` (``weight``: :func:`step_weight`), in one collective
    an axis."""
    grads = [p.grad for p in params if p.grad is not None]
    if not dp.distributed or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.mul_(weight)
    _sum_over_mesh(flat, dp)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], dp: DataParallel, weight: Weight,
                   global_keys: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The weighted mean over the data and sequence axes of each 0-d metric,
    in one collective an axis (the metrics unchanged without a group).
    ``global_keys`` are already the global batch's on every rank (a
    quantizer's perplexity, from code counts summed over the ranks) and are
    kept: a weighted mean of equal values rounds where the weights are not
    powers of two."""
    keep = set(global_keys)
    keys = [k for k in metrics if k not in keep]
    if not dp.distributed or not keys:
        return metrics
    flat = torch.stack([metrics[k].detach().reshape(()).float() for k in keys])
    flat.mul_(weight)
    _sum_over_mesh(flat, dp)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def make_dp_train_step(
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    optimizer: torch.optim.Optimizer,
    dp: DataParallel,
):
    """``step(batch, rows) -> metrics``: ``loss_fn(batch) -> (loss,
    metrics)`` computes the rank's mean loss over its ``rows`` rows (its time
    shard of them on a sequence axis); the backward, the weighted all-reduce
    of the gradients of ``optimizer``'s parameters and of the metrics
    (``loss`` among them; the perplexities are the global batch's already),
    then ``optimizer.step()``."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, rows: int) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        weight = step_weight(rows, dp, loss.device)
        with span("train.backward"):
            loss.backward()
        reduce_gradients(params, dp, weight)
        optimizer.step()
        out = {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
        return reduce_metrics(out, dp, weight, [k for k in out if k.endswith("perplexity")])

    return step
