"""Weights from the JAX package, the localizer's serving closure and its
exported artifact, tracking and resynthesis helpers, and the location
models' evaluation."""

from .compare import (
    compare_location_models,
    evaluate_joint_location,
    evaluate_location,
    infer_location_modes,
    infer_target_mode,
)
from .resynth import audio_from_complex_spec, audio_from_power_spec, spectral_snr_db, write_wav
from .serving import (
    export_localizer,
    full_fp32,
    load_localizer,
    make_serving_fn,
    params_fingerprint,
    store_provenance,
    update_sidecar,
)
from .tracking import alpha_beta_filter, arc_trajectory, track_metrics, walk_trajectory, wrap_angle
from .weights import composite_params_from_jax, params_from_jax

__all__ = [
    "alpha_beta_filter", "arc_trajectory", "audio_from_complex_spec", "audio_from_power_spec",
    "compare_location_models", "composite_params_from_jax", "evaluate_joint_location", "evaluate_location",
    "export_localizer", "full_fp32", "infer_location_modes", "infer_target_mode", "load_localizer",
    "make_serving_fn", "params_fingerprint", "params_from_jax", "spectral_snr_db", "store_provenance",
    "track_metrics", "update_sidecar", "walk_trajectory", "wrap_angle", "write_wav",
]
