"""Weights from the JAX package and from the reference's PyTorch
checkpoints, the port's weights back in the reference's format, the
localizer's serving closure and its exported artifact, the codec's serving
closure, tracking and resynthesis helpers, the location models' evaluation
and the latent-space analysis."""

from .compare import (
    compare_location_models,
    evaluate_joint_location,
    evaluate_location,
    infer_location_modes,
    infer_target_mode,
)
from .latents import collect_encodings, linear_angle_probe, tsne_rir_embedding
from .resynth import audio_from_complex_spec, audio_from_power_spec, spectral_snr_db, write_wav
from .serving import (
    export_localizer,
    full_fp32,
    load_localizer,
    make_codec_serving_fn,
    make_serving_fn,
    params_fingerprint,
    store_provenance,
    update_sidecar,
)
from .torch_import import (
    build_echoed,
    build_location,
    build_vqvae,
    decoder_params,
    echoed_params,
    load_reference_state,
    location_params,
    vqvae_params,
)
from .torch_export import (
    decoder_state_dict,
    echoed_state_dict,
    location_state_dict,
    save_reference_state_dicts,
    vqvae_state_dict,
)
from .tracking import alpha_beta_filter, arc_trajectory, track_metrics, walk_trajectory, wrap_angle
from .weights import composite_params_from_jax, params_from_jax, partition_specs_from_jax

__all__ = [
    "alpha_beta_filter", "arc_trajectory", "audio_from_complex_spec", "audio_from_power_spec", "build_echoed", "build_location", "build_vqvae", "collect_encodings", "compare_location_models",
    "composite_params_from_jax", "decoder_params", "decoder_state_dict", "echoed_state_dict", "echoed_params", "evaluate_joint_location", "evaluate_location",
    "export_localizer", "full_fp32", "infer_location_modes", "infer_target_mode", "linear_angle_probe",
    "load_localizer", "load_reference_state", "location_params", "location_state_dict", "make_codec_serving_fn", "make_serving_fn", "params_fingerprint",
    "params_from_jax", "partition_specs_from_jax", "save_reference_state_dicts", "spectral_snr_db", "store_provenance", "track_metrics", "tsne_rir_embedding",
    "update_sidecar", "vqvae_params", "vqvae_state_dict", "walk_trajectory", "wrap_angle", "write_wav",
]
