"""Weights from the JAX package, the localizer's serving closure and the
location models' evaluation."""

from .compare import (
    compare_location_models,
    evaluate_joint_location,
    evaluate_location,
    infer_location_modes,
    infer_target_mode,
)
from .serving import full_fp32, make_serving_fn
from .weights import composite_params_from_jax, params_from_jax

__all__ = [
    "compare_location_models", "composite_params_from_jax", "evaluate_joint_location", "evaluate_location",
    "full_fp32", "infer_location_modes", "infer_target_mode", "make_serving_fn", "params_from_jax",
]
