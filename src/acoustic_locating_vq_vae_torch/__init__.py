"""acoustic_locating_vq_vae_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``acoustic_locating_vq_vae_tpu``,
ported slice by slice with the same module paths. It imports ``torch`` and
never ``jax`` nor the JAX package. The TPU's Pallas kernels become kernels
written by hand for Hopper (``csrc/``, built with ``nvcc`` for ``sm_90a`` at
first use).

It holds the localizers' serving path (the joint and the frozen localizer,
from an echoed power spectrogram to angle, radius and coordinates) and the
training path of every stage (resident dataset, sampled batch, loss,
backward, Adam): the speech and RIR VQ-VAEs, the echoed-speech composite
(frozen, or with its encoders fine-tuned) with its frozen-latent cache, and
the frozen and the joint location stages, chained in memory by state dicts.
The nearest-codebook assignment, the codebook gradient and the EMA codebook
statistics are CUDA kernels.

Subpackages
-----------
data    DatasetConfig, SampleBatch, SpecsDataset, batch sampling
dsp     znorm, source_coordinates
ops     Conv1d, ConvTranspose1d, Dense, residual stacks, jitter, vector
        quantizer, the CUDA kernels' wrappers and build
models  ConvolutionalVQVAE (encoder, quantizer, decoder),
        EchoedSpeechReconModel, LocationModule, JointLocationModel
train   Task and the six stage tasks (SpeechVQVAETask, RirVQVAETask,
        EchoedSpeechTask, EncoderFinetuneTask, LocationTask,
        JointLocationTask), make_task, graft_pretrained,
        check_flatten_handoff, Trainer, TrainHistory
eval    weights from the JAX package's parameter trees, the serving closure,
        the exported localizer artifact (export_localizer, load_localizer),
        tracking and resynthesis helpers, the location evaluation
cli     the command-line entry points (pipeline, dataset, export, locate,
        track, evaluation sweeps, resynthesis)
utils   device rules (full_fp32, resolve_device), the stage store
"""

__version__ = "0.1.0"

import importlib

__all__ = ["cli", "data", "dsp", "eval", "models", "ops", "train", "utils", "__version__"]


def __getattr__(name: str):
    """Subpackages load on first use, so that importing one module (a
    loaded localizer needs only ``ops.vq``, which registers the assignment's
    operator) does not import the models, the trainer or the data pipeline."""
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
