"""Weights from the JAX package and the localizer's serving closure."""

from .serving import full_fp32, make_serving_fn
from .weights import params_from_jax

__all__ = ["full_fp32", "make_serving_fn", "params_from_jax"]
