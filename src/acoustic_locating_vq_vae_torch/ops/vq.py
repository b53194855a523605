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

Under data parallelism (``process_group``, set by the trainer for its steps
through :func:`global_statistics`) every rank quantizes its own rows and the
statistics are the global batch's, as GSPMD makes them in the JAX package
(``ops/vq.py:159-176, 212-220``): the EMA counts and sums are summed over the
ranks before the decay, the perplexity is taken from the global code counts,
and a dead code k restarts from global row ``k mod N_global`` (the ranks'
blocks in rank order), so the codebook and the EMA buffers stay bitwise equal
on every rank.

Where the work runs follows the tensor alone: a CUDA tensor goes to the
hand-written kernels (``ops/vq_cuda.py``: ``csrc/vq_nearest.cu`` for the
assignment, ``csrc/vq_codebook_accum.cu`` for the codebook gradient and the
EMA statistics), a CPU tensor to the plain versions below. There is no
fallback between them and no switch. The assignment is the registered
operator :func:`vq_nearest` (``torch.ops.acoustic_locating_vq_vae_torch.
vq_nearest``), so that training, the serving closure and an exported
localizer all reach the kernel through one graph node.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .initializers import uniform_
from .vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda

# the assignment's operator, in the package's own namespace: an exported
# localizer names it, and loading one needs only this module imported
VQ_NEAREST_OP = "acoustic_locating_vq_vae_torch::vq_nearest"

__all__ = [
    "VectorQuantizer", "VQOutput", "VQ_NEAREST_OP", "vq_nearest", "nearest_indices", "nearest_codebook", "assign",
    "codebook_grad", "codebook_stats", "codebook_grad_plain", "codebook_stats_plain",
    "perplexity_from_indices", "global_statistics",
]


def nearest_indices(flat_x: torch.Tensor, codebook: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``argmin_k (e2[k] - 2 x . e_k)`` per row,
    the Pallas kernel's score (``||x||^2`` is row-constant and left out).
    ``torch.argmin`` returns the first minimal index, as the kernel does."""
    return torch.argmin(e2 - 2.0 * (flat_x @ codebook.T), dim=1)


def nearest_codebook(flat_x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain nearest-neighbour assignment: (N, D) x (K, D) -> (indices (N,)
    int64, quantized (N, D))."""
    e2 = torch.sum(codebook * codebook, dim=1)
    indices = nearest_indices(flat_x, codebook, e2)
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
    return nearest_indices_cuda(flat_x.contiguous(), cb, torch.sum(cb * cb, dim=1))


@vq_nearest.register_fake
def _vq_nearest_fake(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return flat_x.new_empty((flat_x.shape[0],), dtype=torch.int32)


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
    device. Differentiable in ``codebook`` only."""
    return _Assign.apply(flat_x, codebook)


def perplexity_from_indices(indices: torch.Tensor, num_embeddings: int, group=None) -> torch.Tensor:
    """exp(entropy of code usage) over the given assignments
    (vector_quantizer.py:55-56); with a process ``group``, over every rank's
    assignments (the code counts summed over the ranks, JAX ops/vq.py:212-220)."""
    # int64 in: bincount's count dtype is int64 on every device and in every torch version's fake
    # kernel (some give int32 for int32 ids), so an exported graph's dtype checks hold when it runs
    flat = indices.reshape(-1).long()
    counts = torch.bincount(flat, minlength=num_embeddings).to(torch.float32)
    if group is None:
        avg_probs = counts / flat.shape[0]
    else:
        dist.all_reduce(counts, group=group)
        n = counts.sum()  # the global rows, exact: an integer below 2**24
        # the arithmetic of the line above, so that a world of one is bitwise one device: a CUDA tensor divided
        # by a Python number is multiplied by the number's float32 reciprocal, a CPU tensor is divided by it
        avg_probs = counts * n.reciprocal() if counts.is_cuda else counts / n
    return torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))


def _global_seed_rows(flat: torch.Tensor, k: int, group) -> torch.Tensor:
    """Row ``i mod N_global`` of the global batch for each code ``i``, the
    ranks' blocks of ``flat`` laid end to end in rank order: each rank writes
    the rows it owns into a zero-filled ``(k, D)`` buffer, and the buffers
    are summed (adding zeros is exact). Nothing waits for the device."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n_local = flat.shape[0]
    sizes = torch.zeros(world, dtype=torch.int64, device=flat.device)
    sizes[rank] = n_local
    dist.all_reduce(sizes, group=group)
    offset = torch.sum(sizes[:rank])
    local = torch.arange(k, device=flat.device) % torch.sum(sizes) - offset
    own = (local >= 0) & (local < n_local)
    rows = torch.where(own[:, None], flat[local.clamp(0, n_local - 1)], torch.zeros((), dtype=flat.dtype,
                                                                                      device=flat.device))
    dist.all_reduce(rows, group=group)
    return rows


@contextlib.contextmanager
def global_statistics(module: nn.Module, group):
    """While open, every :class:`VectorQuantizer` in ``module`` reduces its
    statistics over the process ``group`` (None: the rank's own rows); the
    previous groups come back on exit. The trainer opens it around its steps
    only, so that building a cache or serving from its model stays local."""
    vqs = [m for m in module.modules() if isinstance(m, VectorQuantizer)]
    saved = [m.process_group for m in vqs]
    for m in vqs:
        m.process_group = group
    try:
        yield
    finally:
        for m, g in zip(vqs, saved):
            m.process_group = g


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
    ``process_group`` reduces the statistics over the ranks of a data-parallel
    group (see the module docstring and :func:`global_statistics`)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        commitment_cost: float,
        generator: Optional[torch.Generator] = None,
        ema: bool = False,
        ema_decay: float = 0.99,
        ema_reset_threshold: float = 0.0,
        process_group=None,
    ):
        super().__init__()
        self.process_group = process_group
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
        """Codebook rows for stored code ids (the inverse of the assignment)."""
        rows = self._embedding.weight.index_select(0, indices.reshape(-1))
        return rows.reshape(*indices.shape, self.embedding_dim)

    @torch.no_grad()
    def _ema_update(self, indices: torch.Tensor, flat: torch.Tensor) -> None:
        """The JAX ``ops/vq.py:158-201`` update, in place on the buffers."""
        k, group = self.num_embeddings, self.process_group
        counts, sums = codebook_stats(indices, flat, k)
        if group is not None:
            # the global batch's statistics: one sum over the ranks of counts and sums together
            both = torch.cat([counts[:, None], sums], dim=1)
            dist.all_reduce(both, group=group)
            counts, sums = both[:, 0], both[:, 1:]
        decay = self.ema_decay
        new_counts = decay * self.ema_counts + (1 - decay) * counts
        new_sums = decay * self.ema_sums + (1 - decay) * sums
        if self.ema_reset_threshold > 0.0:
            # dead codes restart from batch rows, code id mod rows: reproducible
            dead = new_counts < self.ema_reset_threshold
            if group is None:
                seed_rows = flat[torch.arange(k, device=flat.device) % flat.shape[0]]
            else:
                seed_rows = _global_seed_rows(flat, k, group)
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
        perplexity = perplexity_from_indices(indices, self.num_embeddings, self.process_group)
        encodings = (
            F.one_hot(indices.long(), self.num_embeddings).to(flat.dtype) if need_encodings else None
        )
        return VQOutput(loss, ste, perplexity, indices, encodings)
