"""The process mesh: data, model and sequence axes over ``torch.distributed``
ranks.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel/mesh.py:22-152``. The
JAX package lays its devices out as a ``(data, model, seq)`` grid and lets
GSPMD insert the collectives; here every grid point is a process with its own
device (``torchrun`` starts one per card) and the collectives are explicit:

* :func:`init_data_parallel` joins the process group (NCCL on the card, gloo
  on the CPU or where a node's ranks share a card) from the variables ``torchrun`` sets
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or from explicit arguments,
  and returns the all-data :class:`DataParallel` handle: every rank on the
  data axis;
* :func:`make_mesh` lays those ranks out as the JAX ``make_mesh`` lays out
  devices (:func:`mesh_layout`, the order alone, with JAX's checks) and
  returns the rank's handle with one subgroup per axis: rank r sits at
  ``(d, m, s)`` with ``r = (d * model + m) * seq + s``, data outermost;
  with ``slices`` > 1 the ranks are first grouped node by node (torchrun's
  ``GROUP_RANK``, or an explicit map), so that only the data axis crosses
  nodes;
* :func:`local_mesh` is the world-size-1 handle without a group, the JAX
  ``local_mesh``: a trainer given it, or no handle, runs no collective;
* :func:`shard_batch` gives each rank its contiguous block of rows, the JAX
  ``P("data")`` layout: data coordinate d holds rows ``[d n / D, (d + 1) n / D)``;
* :func:`replicate` broadcasts rank 0's weights into every rank's module.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "DataParallel", "check_replicated", "default_backend", "init_data_parallel", "local_mesh", "make_mesh",
    "mesh_layout", "rank_seed", "replicate", "shard_batch",
]

AXES = ("data", "model", "seq")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank's view of the process mesh.

    ``group``, ``rank`` and ``world_size`` are the data axis: its subgroup
    (None where the axis has one rank), this rank's data coordinate and the
    axis size. ``model_*`` and ``seq_*`` are the same for the tensor and the
    sequence axes. ``world`` spans every rank of the mesh (None for the
    handle of :func:`local_mesh`, which runs no collective) and
    ``global_rank`` is this rank in it."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device
    model_group: Optional[dist.ProcessGroup] = None
    model_rank: int = 0
    model_size: int = 1
    seq_group: Optional[dist.ProcessGroup] = None
    seq_rank: int = 0
    seq_size: int = 1
    world: Optional[dist.ProcessGroup] = None
    global_rank: int = 0
    # the global ranks along each axis through this rank, by coordinate (a subgroup numbers its members in
    # ascending global rank, which a slice-major layout need not follow)
    lines: Tuple[Tuple[int, ...], ...] = ((), (), ())

    @property
    def distributed(self) -> bool:
        return self.world is not None or self.group is not None

    @property
    def world_group(self) -> Optional[dist.ProcessGroup]:
        return self.world if self.world is not None else self.group

    @property
    def lead(self) -> bool:
        """Whether this is the mesh's first rank ``(0, 0, 0)``, which alone
        prints, profiles and writes checkpoints."""
        return (self.rank, self.model_rank, self.seq_rank) == (0, 0, 0)

    def axis(self, name: str) -> Tuple[Optional[dist.ProcessGroup], int, int]:
        """(subgroup, coordinate, size) of the axis ``name``."""
        if name == "data":
            return self.group, self.rank, self.world_size
        if name == "model":
            return self.model_group, self.model_rank, self.model_size
        if name == "seq":
            return self.seq_group, self.seq_rank, self.seq_size
        raise ValueError(f"no mesh axis {name!r}; the axes are {AXES}")

    def peer(self, axis: str, coord: int) -> int:
        """The global rank at coordinate ``coord`` of ``axis`` on this rank's line."""
        return self.lines[AXES.index(axis)][coord]

    def block(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's contiguous block of ``n`` rows on the
        data axis: equal blocks where the axis size divides ``n``, else the
        first ``n % world_size`` coordinates hold one row more
        (``np.array_split``)."""
        base, extra = divmod(n, self.world_size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (self.rank < extra)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM, axis: str = "data") -> torch.Tensor:
        """``t`` reduced over the subgroup of ``axis``, in place (the
        identity where the axis has one rank)."""
        group = self.axis(axis)[0]
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
        return t

    def gather_rows(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """``(size, *t.shape)``: every rank's ``t`` along ``axis``, row c
        from coordinate c. A zero-filled buffer in which each rank writes its
        own row, summed over the subgroup: adding zeros is exact, and a sum
        is the collective every backend has for every device (gloo has no
        all-gather of CUDA tensors)."""
        _, coord, size = self.axis(axis)
        buf = torch.zeros((size, *t.shape), dtype=t.dtype, device=t.device)
        buf[coord] = t
        return self.all_reduce_(buf, axis=axis)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from the mesh's rank ``src`` (its rank within the mesh's
        world) on every rank of the mesh."""
        group = self.world_group
        if group is not None:
            dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
        return t

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the mesh (a MAX reduction,
        which waits for the device)."""
        group = self.world_group
        if group is None:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for every rank of the mesh: a one-element reduction, which
        every backend runs on the rank's own device."""
        group = self.world_group
        if group is not None:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=group)
            t.item()


def rank_seed(seed: int, rank: int) -> int:
    """``seed`` with ``rank`` folded in: ``seed`` itself on rank 0 (so a
    world of one draws the single-process streams), a SeedSequence child
    on every other rank. The trainer folds in the data coordinate, so every
    model and sequence rank of one data row draws the same batch."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


SliceMap = Union[Mapping[int, int], Callable[[int], int], None]


def mesh_layout(world_size: int, data: int = -1, model: int = 1, seq: int = 1, slices: int = 1,
                slice_map: SliceMap = None) -> np.ndarray:
    """The ``(data, model, seq)`` grid of global ranks that the JAX
    ``make_mesh`` (``parallel/mesh.py:22-130``) builds from devices, with its
    checks, for ``world_size`` ranks. ``data=-1`` takes every remaining rank.

    With ``slices`` > 1 (several nodes) the ranks are grouped slice-major
    first: ``slice_map`` gives each rank's slice (a mapping or a callable),
    or, without one, contiguous chunks of ``world_size / slices``. The data
    axis is outermost, so each slice then owns a contiguous block of data
    rows while every model and seq group lies within one slice; a layout
    where model x seq would straddle a slice raises, as do unequal slices,
    and a partial mesh (fewer ranks than the world) takes an equal prefix of
    every slice (``data`` must then divide by ``slices``)."""
    ranks = list(range(world_size))
    n = world_size
    if slices > 1:
        if n % slices:
            raise ValueError(f"{n} ranks not divisible into {slices} slices")
        per_slice = n // slices
        if slice_map is None:
            slice_of = {r: r // per_slice for r in ranks}
        elif callable(slice_map):
            slice_of = {r: slice_map(r) for r in ranks}
        else:
            slice_of = {r: slice_map[r] for r in ranks}
        groups: Dict[int, list] = {}
        for r in ranks:
            groups.setdefault(slice_of[r], []).append(r)
        sizes = {s: len(g) for s, g in groups.items()}
        if len(groups) != slices or any(v != per_slice for v in sizes.values()):
            raise ValueError(f"slice assignment {sizes} does not form {slices} equal slices of {per_slice}")
        if per_slice % (model * seq):
            raise ValueError(
                f"model*seq={model * seq} does not divide the {per_slice} ranks per slice — the model/seq axes "
                "would straddle a node boundary; shrink them to fit within one slice")
        ranks = [r for s in sorted(groups) for r in groups[s]]
    if data == -1:
        if n % (model * seq):
            raise ValueError(f"{n} ranks not divisible by model*seq={model * seq}")
        data = n // (model * seq)
    total = data * model * seq
    if total > n:
        raise ValueError(f"mesh {data}x{model}x{seq} needs {total} ranks, have {n}")
    if slices > 1 and total < n:
        # a prefix of the slice-major order would take every rank from slice 0
        if data % slices:
            raise ValueError(
                f"data={data} not divisible by slices={slices}: each slice must own an equal contiguous block of "
                f"data rows (use data=-1 or a multiple of {slices})")
        per_slice, take = n // slices, total // slices
        ranks = [r for s in range(slices) for r in ranks[s * per_slice: s * per_slice + take]]
    return np.array(ranks[:total], dtype=np.int64).reshape(data, model, seq)


def _node_map(world: "DataParallel") -> Optional[Dict[int, int]]:
    """Every rank's node (torchrun's ``GROUP_RANK``), gathered over the
    world, or None where torchrun set no ``GROUP_RANK``."""
    if "GROUP_RANK" not in os.environ:
        return None
    mine = torch.tensor([int(os.environ["GROUP_RANK"])], dtype=torch.int64, device=world.device)
    size = dist.get_world_size(world.world_group)
    buf = torch.zeros((size, 1), dtype=torch.int64, device=world.device)
    buf[world.global_rank] = mine
    dist.all_reduce(buf, group=world.world_group)
    return {r: int(v) for r, v in enumerate(buf[:, 0].tolist())}


def make_mesh(data: int = -1, model: int = 1, seq: int = 1, slices: int = 1, slice_map: SliceMap = None,
              world: Optional["DataParallel"] = None) -> Optional["DataParallel"]:
    """This rank's handle on the ``(data, model, seq)`` mesh over the ranks of
    ``world`` (the handle :func:`init_data_parallel` returned; None: a world
    of one process, which takes only a mesh of one rank).

    The layout is :func:`mesh_layout`'s; with ``slices`` > 1 and no
    ``slice_map`` the ranks' nodes come from torchrun's ``GROUP_RANK`` where
    it is set. Every rank creates every subgroup (``dist.new_group``, in the
    same order on every rank); an axis of one rank gets none. A rank that a
    partial mesh leaves out gets None."""
    if world is None or not world.distributed:
        device = world.device if world is not None else torch.device("cpu")
        mesh_layout(1, data, model, seq, slices, slice_map)
        return local_mesh(device)
    size = dist.get_world_size(world.world_group)
    if slices > 1 and slice_map is None:
        slice_map = _node_map(world)
    grid = mesh_layout(size, data, model, seq, slices, slice_map)
    me = world.global_rank
    coords = {int(r): c for c, r in np.ndenumerate(grid)}

    def groups(axis: int):
        """The subgroup along ``axis`` that holds this rank, creating all of them."""
        mine = None
        if grid.shape[axis] == 1:
            return None
        lines = np.moveaxis(grid, axis, -1).reshape(-1, grid.shape[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine = g
        return mine

    data_g, model_g, seq_g = groups(0), groups(1), groups(2)
    whole = None if grid.size == size else dist.new_group([int(r) for r in grid.ravel()])
    if me not in coords:
        return None
    d, m, s = coords[me]
    lines = (tuple(int(r) for r in grid[:, m, s]), tuple(int(r) for r in grid[d, :, s]),
             tuple(int(r) for r in grid[d, m, :]))
    return DataParallel(data_g, d, grid.shape[0], world.device, model_g, m, grid.shape[1], seq_g, s,
                        grid.shape[2], world=whole if whole is not None else world.world_group, global_rank=me,
                        lines=lines)


def default_backend(device: torch.device, local_world: int, cards: int) -> str:
    """The process group's backend for ranks on ``device`` with ``local_world``
    ranks on this node and ``cards`` cards in it: NCCL on the card, gloo on
    the CPU and where the node's ranks share a card, which NCCL refuses (a
    ``device`` that names its index, or more ranks than cards)."""
    if device.type != "cuda":
        return "gloo"
    shared = local_world > 1 and (device.index is not None or local_world > cards)
    return "gloo" if shared else "nccl"


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
    device is ``cuda:{local_rank}`` (or the index ``device`` names) and the
    backend NCCL; ``device="cpu"`` takes gloo, and so do ranks that share a
    card, which NCCL refuses: a named index with more than one rank on the
    node, or more ranks on the node (torchrun's ``LOCAL_WORLD_SIZE``) than it
    has cards. ``backend`` overrides the choice; NCCL without a card raises,
    as does a card that is missing."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None and "WORLD_SIZE" in env else world_size
    if rank is None or world_size is None:
        raise RuntimeError("data parallelism needs RANK and WORLD_SIZE (run under torchrun --nproc-per-node N), "
                           "or rank= and world_size=")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if backend is None:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = default_backend(dev, int(env.get("LOCAL_WORLD_SIZE", 1)), cards)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank if dev.index is None else dev.index))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(f"a process group of rank {dist.get_rank()} of {dist.get_world_size()} is already "
                           f"initialised; asked for rank {rank} of {world_size}")
    return DataParallel(dist.group.WORLD, rank, world_size, dev, world=dist.group.WORLD, global_rank=rank)


def local_mesh(device: Union[str, torch.device] = "cuda") -> DataParallel:
    """The world-size-1 handle with no process group: a trainer given it
    behaves as one given none."""
    return DataParallel(None, 0, 1, resolve_device(device))


def shard_batch(batch, dp: DataParallel):
    """This rank's contiguous block of the rows of ``batch`` (a
    ``SampleBatch`` or a tensor) on the data axis, the JAX ``P("data")``
    layout."""
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
