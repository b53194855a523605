"""Tensor sharding on the mesh's ``model`` axis, Megatron-style.

Counterpart of the JAX package's ``shard_params(model_parallel=True)``
(``parallel/mesh.py:145-152``), where GSPMD places the large parameters by
``sharding_rules.param_partition_spec`` and inserts the collectives. Here a
sharded module keeps only its rank's block of the parameter (so the card holds
a share of the weights and of Adam's state) and runs explicit collectives on
the model subgroup:

* a **column-parallel** layer (out-features sharded) computes its block of the
  output channels and gathers them (:func:`model_gather`);
* a **row-parallel** layer (in-features sharded) reads its block of the input
  channels and sums the partial outputs (:func:`model_reduce`);
* a residual block whose 3-tap conv is column-parallel and whose 1x1 conv is
  row-parallel runs the pair without the gather in between: one sum per
  residual branch;
* a bias is added after the collective, so it stays replicated.

The two Megatron functions: :func:`model_copy` ("f": the identity forward,
the sum of the ranks' gradients backward) marks where a replicated activation
enters a sharded layer, and :func:`model_reduce` ("g": the sum forward, the
identity backward) where partial outputs leave it. Every rank of a model group
then holds the same activations and the same gradients of the replicated
parameters, so those need no reduction over the model axis, and a sharded
parameter's gradient is its block of the whole gradient.

:func:`shard_model` applies the partition rules to a built model;
:func:`full_state_dict` and :func:`shard_state_dict` move a checkpoint between
the sharded modules and whole tensors, so a store written under one model
axis size resumes under another.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .sharding_rules import param_partition_spec, sharded_dim

__all__ = [
    "ModelShard", "full_state_dict", "model_copy", "model_gather", "model_reduce", "shard_model",
    "shard_optimizer_state", "shard_state_dict", "full_optimizer_state",
]


class ModelShard:
    """Where a parameter is split: ``dim`` of its torch layout over the
    ``size`` ranks of ``mesh``'s model axis, this rank holding block
    ``rank`` of the ``full`` extent."""

    def __init__(self, mesh, dim: int, full: int):
        self.mesh, self.dim, self.full = mesh, dim, full
        _, self.rank, self.size = mesh.axis("model")
        self.block = full // self.size

    @property
    def lo(self) -> int:
        return self.rank * self.block

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``t``."""
        return t.narrow(self.dim, self.lo, self.block)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block ``t`` (no gradient)."""
        rows = self.mesh.gather_rows(t.detach().contiguous(), "model")
        return torch.cat(rows.unbind(0), dim=self.dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone(), axis="model"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous().clone(), axis="model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.block = mesh, dim, x.shape[dim]
        rows = mesh.gather_rows(x.contiguous(), "model")
        return torch.cat(rows.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        rank = ctx.mesh.axis("model")[1]
        return g.narrow(ctx.dim, rank * ctx.block, ctx.block), None, None


def model_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """"f": ``x`` itself; its gradient summed over the model group."""
    return _Copy.apply(x, mesh)


def model_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """"g": ``x`` summed over the model group; the gradient passed through."""
    return _Reduce.apply(x, mesh)


def model_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model group's blocks ``x`` laid end to end along ``dim`` (a
    zero-filled buffer summed over the group, the collective every backend has
    for every device); the backward keeps the rank's own block of the
    gradient, which every rank of the group holds whole."""
    return _Gather.apply(x, mesh, dim)


def _param_owner(model: nn.Module, name: str):
    module_name, _, attr = name.rpartition(".")
    return model.get_submodule(module_name) if module_name else model, attr


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Split every parameter of ``model`` that the partition rules shard
    (:func:`.sharding_rules.param_partition_spec` on its state-dict name and
    shape) over the model axis of ``mesh``, in place: the owning module keeps
    its rank's block and learns its mode (``model_shard``). A tied parameter
    is split once. Buffers (an EMA codebook) stay whole, as the JAX package
    shards only its ``params``. Returns ``model``; without a model axis it is
    unchanged."""
    if mesh is None or mesh.model_size == 1:
        return model
    done = set()
    for name, p in list(model.named_parameters(remove_duplicate=False)):
        if id(p) in done:
            continue
        done.add(id(p))
        dim = sharded_dim(param_partition_spec(name, tuple(p.shape), mesh.model_size))
        if dim is None:
            continue
        module, attr = _param_owner(model, name)
        shard = ModelShard(mesh, dim, p.shape[dim])
        block = nn.Parameter(shard.take(p.detach()).clone(), requires_grad=p.requires_grad)
        block.model_shard = shard
        setattr(module, attr, block)
        module.model_shard = shard
    return model


def _shard_of(model: nn.Module) -> Dict[str, ModelShard]:
    """State-dict name -> the split of every sharded parameter of ``model``."""
    return {name: p.model_shard for name, p in model.named_parameters(remove_duplicate=False)
            if getattr(p, "model_shard", None) is not None}


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered whole
    over the model group (every rank of the group must call it)."""
    shards = _shard_of(model)
    sd = model.state_dict()
    gathered: Dict[int, torch.Tensor] = {}
    for name, shard in shards.items():
        p = sd[name]
        key = id(model.get_parameter(name))
        if key not in gathered:
            gathered[key] = shard.gather(p)
        sd[name] = gathered[key]
    return sd


def shard_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole-tensor state dict cut to ``model``'s sharded parameters: each
    rank's block where ``model`` holds a block, the tensor itself elsewhere."""
    shards = _shard_of(model)
    return {k: (shards[k].take(v) if k in shards else v) for k, v in state.items()}


def _optimizer_shards(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Optimizer state index -> (its parameter, the parameter's split or None: whole)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: (p, getattr(p, "model_shard", None)) for i, p in enumerate(params)}


def _split_state(st: dict, param: torch.Tensor, shard: Optional[ModelShard], whole: bool) -> dict:
    """A split parameter's optimizer state ``st`` with every tensor gathered
    whole (``whole`` False: ``st`` holds the rank's blocks) or cut to the
    rank's block (``whole``: ``st`` holds whole tensors). Each must have the
    parameter's shape, the layout of Adam's and AdamW's moments, or this
    raises."""
    if shard is None:
        return st
    want = list(param.shape)
    move = shard.gather
    if whole:
        want[shard.dim] = shard.full
        move = shard.take
    out = {}
    for k, v in st.items():
        if torch.is_tensor(v) and v.dim() > 0:
            if list(v.shape) != want:
                raise ValueError(
                    f"optimizer state {k!r} of shape {tuple(v.shape)} for a parameter split over the model axis "
                    f"(shape {tuple(want)}): a whole-tensor checkpoint under model_parallel needs per-parameter "
                    "state of the parameter's shape, as Adam and AdamW keep it"
                )
            v = move(v)
        out[k] = v
    return out


@torch.no_grad()
def full_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the state of every sharded parameter
    gathered whole over the model group."""
    sd = optimizer.state_dict()
    shards = _optimizer_shards(model, optimizer)
    state = {}
    for i, st in sd["state"].items():
        p, shard = shards[i]
        state[i] = _split_state(st, p, shard, whole=False)
    return {**sd, "state": state}


def shard_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer, sd: dict) -> dict:
    """A whole-tensor optimizer state dict cut to the sharded parameters."""
    shards = _optimizer_shards(model, optimizer)
    state = {}
    for i, st in sd["state"].items():
        p, shard = shards[int(i)]
        state[i] = _split_state(st, p, shard, whole=True)
    return {**sd, "state": state}
