"""The data-parallel training step with explicit collectives.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel/dp_step.py:23-57``
(``shard_map`` + ``pmean``): each rank computes the mean loss of its rows and
its backward, the gradients and the scalar metrics are averaged over the
ranks, then every rank takes the same optimizer step. The average is
weighted by each rank's share of the global rows, so it is the global
batch's mean also where the ranks hold unequal blocks; with equal blocks
the weight is ``1 / world_size``, the JAX ``pmean``.

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

from .mesh import DataParallel

__all__ = ["global_rows", "make_dp_train_step", "reduce_gradients", "reduce_metrics"]

Weight = Union[float, torch.Tensor]


def global_rows(rows: int, dp: DataParallel, device: torch.device) -> torch.Tensor:
    """The rows of the global batch, a 0-d float64 tensor on ``device`` (a
    sum over the ranks, which does not wait for the device)."""
    return dp.all_reduce_(torch.tensor(float(rows), dtype=torch.float64, device=device))


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.Tensor], dp: DataParallel, weight: Weight) -> None:
    """Replace each ``p.grad`` by the sum over the ranks of ``weight * p.grad``
    (``weight``: this rank's share of the global rows), in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if not dp.distributed or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.mul_(weight)
    dp.all_reduce_(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], dp: DataParallel, weight: Weight,
                   global_keys: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The weighted mean over the ranks of each 0-d metric, in one
    collective (the metrics unchanged without a group). ``global_keys`` are
    already the global batch's on every rank (a quantizer's perplexity, from
    code counts summed over the ranks) and are kept: a weighted mean of equal
    values rounds where the weights are not powers of two."""
    keep = set(global_keys)
    keys = [k for k in metrics if k not in keep]
    if not dp.distributed or not keys:
        return metrics
    flat = torch.stack([metrics[k].detach().reshape(()).float() for k in keys])
    flat.mul_(weight)
    dp.all_reduce_(flat)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def make_dp_train_step(
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    optimizer: torch.optim.Optimizer,
    dp: DataParallel,
):
    """``step(batch, rows) -> metrics``: ``loss_fn(batch) -> (loss,
    metrics)`` computes the rank's mean loss over its ``rows`` rows; the backward, the weighted all-reduce of
    the gradients of ``optimizer``'s parameters and of the metrics (``loss``
    among them; the perplexities are the global batch's already), then
    ``optimizer.step()``."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, rows: int) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        weight = rows / global_rows(rows, dp, loss.device) if dp.distributed else 1.0
        loss.backward()
        reduce_gradients(params, dp, weight)
        optimizer.step()
        out = {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
        return reduce_metrics(out, dp, weight, [k for k in out if k.endswith("perplexity")])

    return step
