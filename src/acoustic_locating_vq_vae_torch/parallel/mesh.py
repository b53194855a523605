"""The data-parallel process group and each rank's share of a batch.

Counterpart of the ``data`` axis of ``acoustic_locating_vq_vae_tpu/parallel/
mesh.py:22-152``. The JAX package shards one global batch over the devices
of a mesh and lets GSPMD insert the reductions; here every rank is a
process with its own device (``torchrun`` starts one per card) and the
reductions are explicit ``torch.distributed`` collectives:

* :func:`init_data_parallel` joins the process group (NCCL on the card, gloo
  only for ``device="cpu"``) from the variables ``torchrun`` sets
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or from explicit arguments,
  and returns a :class:`DataParallel` handle: the group, the rank, the world
  size and the rank's device;
* :func:`local_mesh` is the world-size-1 handle without a group, the JAX
  ``local_mesh``: a trainer given it, or no handle, runs no collective;
* :func:`shard_batch` gives each rank its contiguous block of rows, the JAX
  ``P("data")`` layout: rank r holds rows ``[r n / W, (r + 1) n / W)``;
* :func:`replicate` broadcasts rank 0's weights into every rank's module.

The model and sequence axes and multi-slice layouts are the next slice of
the port (ROADMAP §A.5): :func:`check_mesh` raises for them, so that no
flag asking for them is silently dropped.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "DataParallel", "check_mesh", "check_replicated", "init_data_parallel", "local_mesh", "rank_seed", "replicate",
    "shard_batch",
]

NEXT_SLICE = "the next slice of the port (ROADMAP §A.5)"


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank's view of the data-parallel group. ``group`` is None for the
    world-size-1 handle of :func:`local_mesh`, which runs no collective."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def block(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's contiguous block of ``n`` rows: equal
        blocks where the world size divides ``n``, else the first
        ``n % world_size`` ranks hold one row more (``np.array_split``)."""
        base, extra = divmod(n, self.world_size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (self.rank < extra)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the group, in place (the identity without one)."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``(world_size, *t.shape)``: every rank's ``t``, row r from rank r.
        A zero-filled buffer in which each rank writes its own row, summed
        over the group: adding zeros is exact, and a sum is the collective
        every backend has for every device (gloo has no all-gather of CUDA
        tensors)."""
        buf = torch.zeros((self.world_size, *t.shape), dtype=t.dtype, device=t.device)
        buf[self.rank] = t
        return self.all_reduce_(buf)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, src=src, group=self.group)
        return t

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (a MAX reduction, which waits
        for the device)."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool(self.all_reduce_(t, dist.ReduceOp.MAX).item())

    def barrier(self) -> None:
        """Wait for every rank: a one-element reduction, which every backend
        runs on the rank's own device."""
        if self.group is not None:
            self.all_reduce_(torch.zeros(1, device=self.device)).item()


def rank_seed(seed: int, rank: int) -> int:
    """``seed`` with ``rank`` folded in: ``seed`` itself on rank 0 (so a
    world of one draws the single-process streams), a SeedSequence child
    on every other rank."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


def check_mesh(model: int = 1, seq: int = 1, slices: int = 1, sequence_parallel: bool = False) -> None:
    """Refuse the mesh axes this slice does not have: tensor sharding on the
    ``model`` axis, time sharding on the ``seq`` axis (``sequence_parallel``)
    and multi-slice layouts."""
    asked = {"model": model, "seq": seq, "slices": slices}
    extra = {k: v for k, v in asked.items() if int(v) != 1}
    if sequence_parallel:
        extra["sequence_parallel"] = True
    if extra:
        raise NotImplementedError(
            f"mesh {extra}: the port shards only the data axis; tensor sharding (model), sequence sharding "
            f"(seq, sequence_parallel) and multi-slice layouts are {NEXT_SLICE}"
        )


def init_data_parallel(
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    timeout_s: float = 600.0,
) -> DataParallel:
    """Join (or reuse) the default process group and return this rank's
    handle. ``rank``, ``world_size`` and ``local_rank`` default to
    ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method``
    to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``). On the card the rank's
    device is ``cuda:{local_rank}`` and the backend NCCL; ``device="cpu"``
    takes gloo. ``backend="gloo"`` with a card is allowed (several ranks on
    one card, which NCCL refuses); NCCL without a card raises, as does a
    card that is missing."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None and "WORLD_SIZE" in env else world_size
    if rank is None or world_size is None:
        raise RuntimeError("data parallelism needs RANK and WORLD_SIZE (run under torchrun --nproc-per-node N), "
                           "or rank= and world_size=")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank if dev.index is None else dev.index))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(f"a process group of rank {dist.get_rank()} of {dist.get_world_size()} is already "
                           f"initialised; asked for rank {rank} of {world_size}")
    return DataParallel(dist.group.WORLD, rank, world_size, dev)


def local_mesh(device: Union[str, torch.device] = "cuda") -> DataParallel:
    """The world-size-1 handle with no process group: a trainer given it
    behaves as one given none."""
    return DataParallel(None, 0, 1, resolve_device(device))


def shard_batch(batch, dp: DataParallel):
    """This rank's contiguous block of the rows of ``batch`` (a
    ``SampleBatch`` or a tensor), the JAX ``P("data")`` layout."""
    n = int((batch.speech_spec if hasattr(batch, "speech_spec") else batch).shape[0])
    lo, hi = dp.block(n)
    if hasattr(batch, "map"):
        return batch.map(lambda a: a[lo:hi])
    return batch[lo:hi]


def _tensors(module: torch.nn.Module) -> Iterable[torch.Tensor]:
    """The module's parameters and buffers, each once (a tied block's once)."""
    seen = set()
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            yield t


@torch.no_grad()
def replicate(module: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers into ``module`` on every
    rank, in place."""
    for t in _tensors(module):
        dp.broadcast_(t.data)
    return module


@torch.no_grad()
def check_replicated(module: torch.nn.Module, dp: DataParallel, what: str = "weights") -> None:
    """Raise on every rank unless every rank's parameters and buffers are
    bitwise rank 0's: each tensor is broadcast from rank 0 and compared, and
    the verdict is reduced over the group."""
    if not dp.distributed:
        return
    differ = 0
    for t in _tensors(module):
        ref = dp.broadcast_(t.detach().clone())
        differ += int(not torch.equal(ref, t))
    if dp.any(differ > 0):
        raise RuntimeError(f"{what} differ between the ranks after construction (rank {dp.rank}: {differ} tensors "
                           "differ from rank 0's): every rank must draw them from the same seed")
