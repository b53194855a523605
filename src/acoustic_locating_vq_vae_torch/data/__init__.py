"""Dataset configuration, the sample batch, its synthesis on the device and
the disk-backed dataset."""

from .config import DatasetConfig
from .dataset import SpecsDataset, sample_without_replacement, save_dataset, save_dataset_reference_format
from .speech import load_wav_dir, synthetic_speech_batch
from .synth import (
    SampleBatch,
    SynthDraws,
    bank_thetas,
    draw_synthesis,
    geometry_boxes,
    make_dataset,
    make_rir_bank,
    max_source_radius,
    observed_power_spec,
    prune_batch,
    rirs_from_draws,
    synthesize_batch,
    synthesize_from_draws,
)

__all__ = [
    "DatasetConfig", "SampleBatch", "SpecsDataset", "SynthDraws", "bank_thetas", "draw_synthesis", "geometry_boxes",
    "load_wav_dir", "make_dataset", "make_rir_bank", "max_source_radius", "observed_power_spec", "prune_batch",
    "rirs_from_draws", "sample_without_replacement", "save_dataset", "save_dataset_reference_format", "synthesize_batch",
    "synthesize_from_draws", "synthetic_speech_batch",
]
