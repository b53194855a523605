"""Partition rules for the model axis, on the port's names and layouts.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel/sharding_rules.py:25-62``
(``param_partition_spec``), with the same decisions written on the port's
state-dict names and torch layouts:

* the codebook ``..._vq._embedding.weight`` (K, D) splits by code rows;
* a conv weight splits Megatron-style: a residual block's 1x1 conv
  (``..._block.3.weight``, JAX's ``conv_2``) by its in-features (row
  parallel), any other conv by its out-features (column parallel), else by
  its in-features; the port's conv weight is ``(out, in, k)`` and its
  transposed conv's ``(in, out, k)`` (``_conv_trans_*``), where flax's kernels
  are ``(k, in, out)``;
* a dense weight ``(out, in)`` (flax's kernel is ``(in, out)``) splits by its
  larger dimension, the in-features on a tie;
* nothing under 256 or not divisible by the model axis is split, and biases
  never are.

A spec is a tuple with ``"model"`` at the split dim of the torch layout and
None elsewhere, or ``()`` for a replicated parameter (JAX's ``P()``).
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["MIN_SHARD_DIM", "param_partition_spec", "sharded_dim"]

MIN_SHARD_DIM = 256  # don't shard small tensors

Spec = Tuple[Optional[str], ...]


def _spec(ndim: int, dim: int) -> Spec:
    return tuple("model" if i == dim else None for i in range(ndim))


def param_partition_spec(name: str, shape: Tuple[int, ...], model_axis_size: int) -> Spec:
    """The spec of the parameter ``name`` (a state-dict key) of ``shape`` on a
    model axis of ``model_axis_size`` ranks."""
    parts = name.split(".")

    def divisible(dim: int) -> bool:
        return dim >= MIN_SHARD_DIM and dim % model_axis_size == 0

    if parts[-1] != "weight":
        return ()
    if len(parts) >= 2 and parts[-2] == "_embedding":  # the VQ codebook (K, D)
        return _spec(2, 0) if divisible(shape[0]) else ()
    if len(shape) == 3:
        transposed = any(p.startswith("_conv_trans") for p in parts)
        out_dim, in_dim = (1, 0) if transposed else (0, 1)
        cout, cin = shape[out_dim], shape[in_dim]
        if len(parts) >= 3 and parts[-3] == "_block" and parts[-2] == "3" and divisible(cin):
            return _spec(3, in_dim)  # row-parallel 1x1 conv_2
        if divisible(cout):
            return _spec(3, out_dim)  # column-parallel
        if divisible(cin):
            return _spec(3, in_dim)
        return ()
    if len(shape) == 2:  # dense (out, in)
        cout, cin = shape
        if divisible(cin) and cin >= cout:
            return _spec(2, 1)
        if divisible(cout):
            return _spec(2, 0)
    return ()


def sharded_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits, or None for a replicated one."""
    return spec.index("model") if "model" in spec else None
