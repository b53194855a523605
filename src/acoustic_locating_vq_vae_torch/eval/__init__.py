"""Weights from the JAX package and the localizer's serving closure."""

from .serving import full_fp32, make_serving_fn
from .weights import composite_params_from_jax, params_from_jax

__all__ = ["composite_params_from_jax", "full_fp32", "make_serving_fn", "params_from_jax"]
