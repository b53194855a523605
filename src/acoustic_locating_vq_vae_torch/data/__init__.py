"""Dataset configuration, the sample batch and the disk-backed dataset."""

from .config import DatasetConfig
from .dataset import SpecsDataset, sample_without_replacement, save_dataset
from .synth import SampleBatch

__all__ = ["DatasetConfig", "SampleBatch", "SpecsDataset", "sample_without_replacement", "save_dataset"]
