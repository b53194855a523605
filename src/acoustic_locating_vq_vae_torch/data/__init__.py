"""Dataset configuration, the sample batch, its synthesis on the device and
the disk-backed dataset."""

from .config import DatasetConfig
from .collate import combine_arrays_with_min_dim, spec_dataset_preprocessing
from .dataset import (
    HostStagedDataset,
    SpecsDataset,
    make_host_dataset,
    sample_without_replacement,
    save_dataset,
    save_dataset_reference_format,
)
from .flac import decode_flac, read_flac
from .speech import load_librispeech, load_wav_dir, synthetic_speech_batch
from .synth import (
    SampleBatch,
    SynthDraws,
    bank_thetas,
    draw_synthesis,
    echoed_from_draws,
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
    "DatasetConfig", "HostStagedDataset", "SampleBatch", "SpecsDataset", "SynthDraws", "bank_thetas",
    "combine_arrays_with_min_dim", "decode_flac", "draw_synthesis", "echoed_from_draws", "geometry_boxes", "load_librispeech",
    "load_wav_dir", "make_dataset", "make_host_dataset", "make_rir_bank", "max_source_radius", "observed_power_spec",
    "prune_batch", "read_flac", "rirs_from_draws", "sample_without_replacement", "save_dataset",
    "save_dataset_reference_format", "spec_dataset_preprocessing", "synthesize_batch", "synthesize_from_draws",
    "synthetic_speech_batch",
]
