"""Vector quantizer (reference: vq_vae/vector_quantizer.py:8-58).

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/vq.py``:

* ``train_vq=True`` (the default, gradient mode): ``loss = q_latent + beta *
  e_latent`` with ``q_latent = mean((q - sg(x))^2)`` training the codebook by
  gradient. The codebook gradient is the backward of :class:`_Assign`, and
  the input gradient through the assignment is zero (the JAX
  ``vq_pallas.py:181-188``); the straight-through output carries the input
  gradient.
* ``train_vq=False``: the frozen codebook, same loss value, no gradient into
  the codebook (vector_quantizer.py:50). The latent getters and serving use it.
* ``ema=True``: the codebook, the EMA counts and the EMA sums are buffers,
  updated inside the forward on training steps (``train_vq`` and
  ``self.training``) from the batch's per-code counts and sums, with
  optional dead-code restart; the loss is ``beta * e_latent`` only.

On a process mesh (``mesh``, set by the trainer for its steps through
:func:`global_statistics`) every rank quantizes its own rows and the
statistics are the global batch's, as GSPMD and the JAX quantizer's
``sequence_axis`` make them (``ops/vq.py:91-95, 145-219``): the EMA counts
and sums are summed over the data and sequence axes before the decay, the
perplexity is taken from the code counts summed over both; a dead code k
restarts from global row ``k mod N_global`` of the data axis (the ranks'
blocks in rank order) and, on a sequence axis, from the mean over the time
shards of each shard's such row (JAX ``:186-190``), so the codebook and the
EMA buffers stay bitwise equal on every rank. The loss is the rank's own mean
over its rows: the trainer averages losses and gradients over the axes.

A codebook split by rows over the mesh's model axis (``parallel/tensor.py``,
JAX ``sharding_rules.py:33-34``) assigns in three steps that keep the rule
"first index on exact ties" (:class:`_ShardedAssign`): each rank finds its
block's winner and that winner's score (:func:`vq_nearest_scored`, the same
kernel), the ranks' (score, global index) pairs are merged in coordinate
order, the least score winning and an equal score going to the lower index
(:func:`merge_nearest`), and each row is read from the rank that owns its
code and summed over the group. The kernel's score of a code does not depend
on how the codebook is split, nor does its row norm (:func:`code_norms`, the
norm of every path), so the merged ids are the unsplit kernel's.

Where the work runs follows the tensor alone: a CUDA tensor goes to the
hand-written kernels (``ops/vq_cuda.py``: ``csrc/vq_nearest.cu`` for the
assignment, ``csrc/vq_codebook_accum.cu`` for the codebook gradient and the
EMA statistics), a CPU tensor to the plain versions below. There is no
fallback between them and no switch. The assignment is the registered
operator :func:`vq_nearest` (``torch.ops.acoustic_locating_vq_vae_torch.
vq_nearest``), so that training, the serving closure and an exported
localizer all reach the kernel through one graph node.

:class:`ResidualVectorQuantizer` is EnCodec's residual quantizer, serving only:
a chain of stages, each assigning the residual the stages before it left
(:func:`residual_codes`). It calls the operator and a codebook row lookup
directly, not :class:`VectorQuantizer`'s forward, whose loss and perplexity
(a ``bincount`` read back to the host) a served call has no use for.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import uniform_
from .span import span
from .vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda

# the assignment's operator, in the package's own namespace: an exported
# localizer names it, and loading one needs only this module imported
VQ_NEAREST_OP = "acoustic_locating_vq_vae_torch::vq_nearest"
# the same kernel with each row's winning score, for a codebook split over ranks
VQ_NEAREST_SCORED_OP = "acoustic_locating_vq_vae_torch::vq_nearest_scored"

__all__ = [
    "VectorQuantizer", "VQOutput", "VQ_NEAREST_OP", "VQ_NEAREST_SCORED_OP", "vq_nearest", "vq_nearest_scored",
    "code_norms", "nearest_indices", "nearest_scored", "merge_nearest", "nearest_codebook", "assign",
    "codebook_grad", "codebook_stats", "codebook_grad_plain", "codebook_stats_plain",
    "perplexity_from_indices", "global_statistics", "ResidualVectorQuantizer", "residual_codes",
]


def code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """The codebook's squared row norms ``||e_k||^2`` (K,), summed as a
    pairwise tree over the features whose shape depends on D alone (odd
    widths padded with a zero). Each step is an elementwise IEEE product or
    sum, so a code's norm is bitwise the same in any codebook it is part of
    and on either device: a codebook split by rows over ranks gives every code
    the unsplit codebook's norm, where a row-sum reduction's order follows K."""
    s = codebook * codebook
    while s.shape[1] > 1:
        if s.shape[1] % 2:
            s = F.pad(s, (0, 1))
        s = s[:, 0::2] + s[:, 1::2]
    return s[:, 0]


def nearest_indices(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``argmin_k (e2[k] - 2 x . e_k)`` per row,
    the Pallas kernel's score (``||x||^2`` is row-constant and left out).
    ``torch.argmin`` returns the first minimal index, as the kernel does."""
    return torch.argmin(e2 - 2.0 * (flat_x @ codebook.T), dim=1)


def nearest_scored(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel with its second output: ``(indices,
    scores)``, the :func:`nearest_indices` ids and each row's score at that
    id, ``e2[k] - 2 x . e_k``."""
    scores = e2 - 2.0 * (flat_x @ codebook.T)
    indices = torch.argmin(scores, dim=1)
    return indices, scores.gather(1, indices[:, None])[:, 0]


def merge_nearest(scores: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The winners of a codebook split by rows: ``scores`` and ``ids`` are
    ``(S, N)``, row s the winners of block s (global code ids, the blocks in
    ascending code order). Per column, the least score wins and an equal score
    keeps the earlier block, whose ids are lower: the first index on exact
    ties, as one unsplit argmin gives it. Returns ``(score, id)``, ``(N,)``."""
    best, bid = scores[0], ids[0]
    for s in range(1, scores.shape[0]):
        better = scores[s] < best
        best = torch.where(better, scores[s], best)
        bid = torch.where(better, ids[s], bid)
    return best, bid


def nearest_codebook(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain nearest-neighbour assignment: (N, D) x (K, D) -> (indices (N,)
    int64, quantized (N, D))."""
    indices = nearest_indices(flat_x, codebook, code_norms(codebook))
    return indices, codebook.index_select(0, indices)


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no vector-quantizer kernel for device {t.device}")
    return t.device.type


@torch.library.custom_op(VQ_NEAREST_OP, mutates_args=(), device_types="cpu")
def vq_nearest(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The assignment as one registered operator: int32 code ids ``(N,)`` of
    the nearest codebook rows. On the CPU the plain version; on the card
    (below) the ``csrc/vq_nearest.cu`` kernel, with no fallback. Being an
    operator and not a Python call, it is what ``torch.export`` records: an
    exported localizer holds this node (never ``argmin``), and a loaded
    artifact dispatches it to the kernel on the card."""
    return nearest_codebook(flat_x, codebook)[0].to(torch.int32)


@vq_nearest.register_kernel("cuda")
def _vq_nearest_cuda(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    cb = codebook.contiguous()
    # the module's name is read at each call, so a wrapper put in its place (a launch counter) is the one called
    return nearest_indices_cuda(flat_x.contiguous(), cb, code_norms(cb))[0]


@vq_nearest.register_fake
def _vq_nearest_fake(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return flat_x.new_empty((flat_x.shape[0],), dtype=torch.int32)


@torch.library.custom_op(VQ_NEAREST_SCORED_OP, mutates_args=(), device_types="cpu")
def vq_nearest_scored(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`vq_nearest` with its second output: int32 ids ``(N,)`` and each
    row's winning float32 score ``(N,)``. On the CPU the plain version
    (:func:`nearest_scored`); on the card the same ``csrc/vq_nearest.cu``
    kernel, whose score output this is."""
    indices, scores = nearest_scored(flat_x, codebook, code_norms(codebook))
    return indices.to(torch.int32), scores


@vq_nearest_scored.register_kernel("cuda")
def _vq_nearest_scored_cuda(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    cb = codebook.contiguous()
    return nearest_indices_cuda(flat_x.contiguous(), cb, code_norms(cb))


@vq_nearest_scored.register_fake
def _vq_nearest_scored_fake(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = flat_x.shape[0]
    return flat_x.new_empty((n,), dtype=torch.int32), flat_x.new_empty((n,), dtype=torch.float32)


def _assign_indices(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """int32 code ids, the kernel's own dtype, on either device, through the
    registered operator."""
    _device_type(flat_x)
    return vq_nearest(flat_x, codebook)


def codebook_grad_plain(indices: torch.Tensor, g: torch.Tensor, num_embeddings: int) -> torch.Tensor:
    """Plain version of the accumulation kernel: ``one_hot(indices)^T @ g``,
    (K, D), as ``index_add_`` (the JAX xla backend's scatter-add,
    ``ops/vq.py:167-172``). Indices must lie in ``[0, K)``."""
    out = torch.zeros(num_embeddings, g.shape[1], dtype=g.dtype, device=g.device)
    return out.index_add_(0, indices, g)


def codebook_stats_plain(indices: torch.Tensor, x: torch.Tensor, num_embeddings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the statistics pass: per-code counts (K,) float32 and
    row sums (K, D)."""
    counts = torch.bincount(indices, minlength=num_embeddings).to(torch.float32)
    return counts, codebook_grad_plain(indices, x, num_embeddings)


def codebook_grad(indices: torch.Tensor, g: torch.Tensor, num_embeddings: int) -> torch.Tensor:
    """:func:`codebook_grad_plain` for a CPU tensor, the CUDA kernel for a
    CUDA tensor; raises for any other device."""
    if _device_type(g) == "cpu":
        return codebook_grad_plain(indices, g, num_embeddings)
    return codebook_grad_cuda(indices, g.contiguous(), num_embeddings)


def codebook_stats(indices: torch.Tensor, x: torch.Tensor, num_embeddings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`codebook_stats_plain` for a CPU tensor, the CUDA kernel for a
    CUDA tensor; raises for any other device."""
    if _device_type(x) == "cpu":
        return codebook_stats_plain(indices, x, num_embeddings)
    return codebook_stats_cuda(indices, x.contiguous(), num_embeddings)


class _Assign(torch.autograd.Function):
    """(indices, quantized) of the nearest codebook rows; the backward gives
    the codebook its gradient by :func:`codebook_grad` and the inputs none
    (the argmin is locally constant), as the Pallas custom VJP does."""

    @staticmethod
    def forward(ctx, flat_x, codebook):
        indices = _assign_indices(flat_x, codebook)
        ctx.save_for_backward(indices)
        ctx.num_embeddings = codebook.shape[0]
        ctx.mark_non_differentiable(indices)
        return indices, codebook.index_select(0, indices)

    @staticmethod
    def backward(ctx, _, grad_q):
        (indices,) = ctx.saved_tensors
        d_cb = codebook_grad(indices, grad_q, ctx.num_embeddings) if ctx.needs_input_grad[1] else None
        return None, d_cb  # None: autograd's zero, no (N, D) tensor is made for it


def assign(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (N,) int32, quantized (N, D)): :func:`nearest_codebook` for a
    CPU tensor, the CUDA kernel for a CUDA tensor; raises for any other
    device. Differentiable in ``codebook`` only. A codebook parameter split
    over a model axis (its ``model_shard``) assigns over the whole codebook
    (:class:`_ShardedAssign`)."""
    shard = getattr(codebook, "model_shard", None)
    if shard is not None:
        return _ShardedAssign.apply(flat_x, codebook, shard)
    return _Assign.apply(flat_x, codebook)


def _owned(indices: torch.Tensor, shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(whether this rank's block holds each global code id, the id within
    the block, 0 where it does not)."""
    local = indices.long() - shard.lo
    own = (local >= 0) & (local < shard.block)
    return own, torch.where(own, local, torch.zeros_like(local))


def _sharded_rows(codebook: torch.Tensor, indices: torch.Tensor, shard) -> torch.Tensor:
    """This rank's block's rows of the codes it owns, zero elsewhere: the
    rank's term of the sum over the model group that reads every row."""
    own, local = _owned(indices, shard)
    rows = codebook.index_select(0, local)
    return torch.where(own[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


class _ShardedAssign(torch.autograd.Function):
    """:class:`_Assign` for a codebook split by rows over a model axis: the
    block's winners with their scores, merged over the group in coordinate
    order (:func:`merge_nearest`), then each row read from its owner and
    summed over the group. The backward gives the block the gradient of the
    rows it owns."""

    @staticmethod
    def forward(ctx, flat_x, codebook, shard):
        _device_type(flat_x)
        ids, scores = vq_nearest_scored(flat_x, codebook)
        mesh = shard.mesh
        scores = mesh.gather_rows(scores, "model")
        ids = mesh.gather_rows(ids.long() + shard.lo, "model")
        indices = merge_nearest(scores, ids)[1].to(torch.int32)
        own, local = _owned(indices, shard)
        quantized = mesh.all_reduce_(_sharded_rows(codebook, indices, shard), axis="model")
        ctx.save_for_backward(own, local.to(torch.int32))
        ctx.block = shard.block
        ctx.mark_non_differentiable(indices)
        return indices, quantized

    @staticmethod
    def backward(ctx, _, grad_q):
        own, local = ctx.saved_tensors
        d_cb = None
        if ctx.needs_input_grad[1]:
            g = torch.where(own[:, None], grad_q, torch.zeros((), dtype=grad_q.dtype, device=grad_q.device))
            d_cb = codebook_grad(local, g, ctx.block)
        return None, d_cb, None


def _reduces(mesh, seq: bool) -> bool:
    """Whether statistics are summed over ``mesh``: over its data axis, and
    with ``seq`` over its sequence axis."""
    return mesh is not None and (mesh.group is not None or (seq and mesh.seq_group is not None))


def _reduce_counts(counts: torch.Tensor, mesh, seq: bool) -> bool:
    """Sum ``counts`` over the data axis of ``mesh`` (and with ``seq`` its
    sequence axis) in place; whether there was anything to sum over."""
    if not _reduces(mesh, seq):
        return False
    mesh.all_reduce_(counts)
    if seq:
        mesh.all_reduce_(counts, axis="seq")
    return True


def perplexity_from_indices(indices: torch.Tensor, num_embeddings: int, mesh=None, seq: bool = True) -> torch.Tensor:
    """exp(entropy of code usage) over the given assignments
    (vector_quantizer.py:55-56); on a process ``mesh``, over every rank's
    assignments on the data axis and, with ``seq``, on the sequence axis (the
    code counts summed over them, JAX ops/vq.py:212-220)."""
    with span("vq.perplexity"):
        # int64 in: bincount's count dtype is int64 on every device and in every torch version's fake
        # kernel (some give int32 for int32 ids), so an exported graph's dtype checks hold when it runs
        flat = indices.reshape(-1).long()
        counts = torch.bincount(flat, minlength=num_embeddings).to(torch.float32)
        if not _reduce_counts(counts, mesh, seq):
            avg_probs = counts / flat.shape[0]
        else:
            n = counts.sum()  # the global rows, exact: an integer below 2**24
            # the arithmetic of the line above, so that a world of one is bitwise one device: a CUDA tensor
            # divided by a Python number is multiplied by the number's float32 reciprocal, a CPU tensor is
            # divided by it
            avg_probs = counts * n.reciprocal() if counts.is_cuda else counts / n
        return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))


def _seed_rows(flat: torch.Tensor, k: int, mesh, seq: bool) -> torch.Tensor:
    """The rows dead codes restart from: row ``i mod N_global`` of the data
    axis's global batch for each code ``i`` (the ranks' blocks of ``flat``
    laid end to end in data order; each rank writes the rows it owns into a
    zero-filled ``(k, D)`` buffer, and the buffers are summed, adding zeros
    exactly), then on a sequence axis the mean of those rows over the time
    shards (JAX ``ops/vq.py:186-190``). Nothing waits for the device."""
    n_local = flat.shape[0]
    codes = torch.arange(k, device=flat.device)
    if mesh is None or mesh.group is None:
        rows = flat[codes % n_local]
    else:
        sizes = mesh.gather_rows(torch.tensor(n_local, dtype=torch.int64, device=flat.device))
        local = codes % torch.sum(sizes) - torch.sum(sizes[:mesh.rank])
        own = (local >= 0) & (local < n_local)
        rows = torch.where(own[:, None], flat[local.clamp(0, n_local - 1)],
                           torch.zeros((), dtype=flat.dtype, device=flat.device))
        mesh.all_reduce_(rows)
    if seq and mesh is not None and mesh.seq_group is not None:
        rows = mesh.all_reduce_(rows, axis="seq") / mesh.seq_size
    return rows


@contextlib.contextmanager
def global_statistics(module: nn.Module, mesh):
    """While open, every :class:`VectorQuantizer` in ``module`` reduces its
    statistics over the data and sequence axes of ``mesh`` (None: the rank's
    own rows); the previous meshes come back on exit. The trainer opens it
    around its steps only, so that building a cache or serving from its model
    stays local."""
    vqs = [m for m in module.modules() if isinstance(m, VectorQuantizer)]
    saved = [m.mesh for m in vqs]
    for m in vqs:
        m.mesh = mesh
    try:
        yield
    finally:
        for m, g in zip(vqs, saved):
            m.mesh = g


EMA_EPS = 1e-5  # Laplace smoothing of the EMA counts (JAX ops/vq.py ema_eps)


class VQOutput(NamedTuple):
    loss: torch.Tensor
    quantized: torch.Tensor  # straight-through, input shape
    perplexity: torch.Tensor
    indices: torch.Tensor  # (N,) int32 code ids
    encodings: Optional[torch.Tensor] = None  # (N, K) one-hot, on request


class VectorQuantizer(nn.Module):
    """Vector quantizer. The codebook is ``_embedding.weight`` (K, D), the
    reference's key, drawn U(-1/K, 1/K): a parameter in gradient mode, a
    buffer (beside ``ema_counts`` and ``ema_sums``) in EMA mode.
    ``mesh`` reduces the statistics over the data axis of a process mesh,
    and over its sequence axis where the quantizer is built with a
    ``sequence_axis`` (see the module docstring and
    :func:`global_statistics`); a gradient-mode codebook may be split over its
    model axis (``parallel.shard_model``)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        commitment_cost: float,
        generator: Optional[torch.Generator] = None,
        ema: bool = False,
        ema_decay: float = 0.99,
        ema_reset_threshold: float = 0.0,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        self.mesh = None  # set while a step runs on a process mesh (global_statistics)
        self.sequence_axis = sequence_axis
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.ema = ema
        self.ema_decay = ema_decay
        self.ema_reset_threshold = ema_reset_threshold
        weight = uniform_(torch.empty(num_embeddings, embedding_dim), 1.0 / num_embeddings, generator)
        self._embedding = nn.Module()
        if ema:
            self._embedding.register_buffer("weight", weight)
            self.register_buffer("ema_counts", torch.ones(num_embeddings))
            self.register_buffer("ema_sums", weight.clone())
        else:
            self._embedding.weight = nn.Parameter(weight)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook rows for stored code ids (the inverse of the assignment);
        a codebook split over a model axis reads each row from its owner."""
        weight = self._embedding.weight
        shard = getattr(weight, "model_shard", None)
        if shard is None:
            rows = weight.index_select(0, indices.reshape(-1))
        else:
            from ..parallel.tensor import model_reduce

            rows = model_reduce(_sharded_rows(weight, indices.reshape(-1), shard), shard.mesh)
        return rows.reshape(*indices.shape, self.embedding_dim)

    @torch.no_grad()
    def _ema_update(self, indices: torch.Tensor, flat: torch.Tensor) -> None:
        """The JAX ``ops/vq.py:158-201`` update, in place on the buffers."""
        k, mesh, seq = self.num_embeddings, self.mesh, self.sequence_axis is not None
        counts, sums = codebook_stats(indices, flat, k)
        if _reduces(mesh, seq):
            # the global batch's statistics: one sum an axis of counts and sums together
            both = torch.cat([counts[:, None], sums], dim=1)
            _reduce_counts(both, mesh, seq)
            counts, sums = both[:, 0], both[:, 1:]
        decay = self.ema_decay
        new_counts = decay * self.ema_counts + (1 - decay) * counts
        new_sums = decay * self.ema_sums + (1 - decay) * sums
        if self.ema_reset_threshold > 0.0:
            # dead codes restart from batch rows, code id mod rows: reproducible
            dead = new_counts < self.ema_reset_threshold
            seed_rows = _seed_rows(flat, k, mesh, seq)
            new_sums = torch.where(dead[:, None], seed_rows, new_sums)
            new_counts = torch.where(dead, torch.ones_like(new_counts), new_counts)
        n = torch.sum(new_counts)
        smoothed = (new_counts + EMA_EPS) / (n + k * EMA_EPS) * n
        self.ema_counts.copy_(new_counts)
        self.ema_sums.copy_(new_sums)
        self._embedding.weight.copy_(new_sums / smoothed[:, None])

    def forward(self, inputs: torch.Tensor, train_vq: bool = True, need_encodings: bool = False) -> VQOutput:
        """``inputs``: (..., D) latents, channels last. ``quantized`` has the
        input shape; ``encodings`` is None unless ``need_encodings``."""
        with span("vq.quantize"):
            flat = inputs.reshape(-1, self.embedding_dim)
            indices, quantized = assign(flat, self._embedding.weight)
            e_latent_loss = torch.mean((quantized.detach() - flat) ** 2)
            if self.ema:
                q_latent_loss = torch.zeros((), dtype=flat.dtype, device=flat.device)
                if train_vq and self.training:
                    self._ema_update(indices, flat.detach())
            elif train_vq:
                q_latent_loss = torch.mean((quantized - flat.detach()) ** 2)
            else:
                # frozen codebook: same value, no gradient (vector_quantizer.py:50)
                q_latent_loss = torch.mean((quantized - flat) ** 2).detach()
            loss = q_latent_loss + self.commitment_cost * e_latent_loss

            quantized = quantized.reshape(inputs.shape)
            ste = inputs + (quantized - inputs).detach()
            perplexity = perplexity_from_indices(indices, self.num_embeddings, self.mesh,
                                                 self.sequence_axis is not None)
            encodings = (
                F.one_hot(indices.long(), self.num_embeddings).to(flat.dtype) if need_encodings else None
            )
            return VQOutput(loss, ste, perplexity, indices, encodings)


def residual_codes(x: torch.Tensor, codebooks) -> torch.Tensor:
    """The residual quantizer's chain on ``x`` (N, D): stage ``i`` assigns
    the residual left by the stages before it to its codebook (K, D) by
    :func:`vq_nearest` (first index on exact ties) and subtracts the rows it
    picked (EnCodec's ``EncodecResidualVectorQuantizer.encode``). Returns the
    int32 ids ``(n_q, N)``. ``residual_codes.stages`` counts the stages run."""
    residual, ids = x, []
    for codebook in codebooks:
        i = vq_nearest(residual, codebook)
        residual = residual - codebook.index_select(0, i)
        ids.append(i)
    residual_codes.stages += len(ids)
    return torch.stack(ids)


residual_codes.stages = 0


class _Codebook(nn.Module):
    """One stage's codebook under EnCodec's buffer names
    (``EncodecEuclideanCodebook``): ``embed`` (K, D) is the codebook;
    ``inited``, ``cluster_size`` and ``embed_avg`` are its training state,
    kept so that the state dict is the published one."""

    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.register_buffer("inited", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))


class _Stage(nn.Module):
    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.codebook = _Codebook(codebook_size, dim)


class ResidualVectorQuantizer(nn.Module):
    """EnCodec's residual vector quantizer (``quantizer.layers.<i>.codebook.*``):
    ``num_quantizers`` stages of ``codebook_size`` codes of ``dim``.
    :meth:`encode` runs the first ``n_q`` stages of the chain in the span
    ``rvq.encode``; :meth:`decode` sums the stages' rows of given codes in the
    span ``rvq.decode``, in stage order from zero, as EnCodec's decode does."""

    def __init__(self, num_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(_Stage(codebook_size, dim) for _ in range(num_quantizers))

    def encode(self, x: torch.Tensor, n_q: int) -> torch.Tensor:
        """int32 codes ``(n_q, N)`` of the rows of ``x`` (N, D)."""
        with span("rvq.encode"):
            return residual_codes(x, [stage.codebook.embed for stage in self.layers[:n_q]])

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """The quantized rows ``(N, D)`` of ``codes`` (n_q, N)."""
        with span("rvq.decode"):
            out = None
            for stage, ids in zip(self.layers, codes):
                rows = stage.codebook.embed.index_select(0, ids)
                out = rows if out is None else out + rows
            return out
