"""Stage task specs, the stage handoff, the training loop and the pipeline."""

from .loop import Preempted, Trainer, TrainHistory, checkpoint_metadata
from .pipeline import fit_joint_recipe, run_pipeline, run_stage, stage_seed
from .tasks import (
    CodecTask,
    EchoedSpeechTask,
    EncoderFinetuneTask,
    JointLocationTask,
    LocationTask,
    RirVQVAETask,
    SpeechVQVAETask,
    Task,
    check_flatten_handoff,
    graft_pretrained,
    make_task,
    resolved_vq_flatten,
)

__all__ = [
    "CodecTask", "EchoedSpeechTask", "EncoderFinetuneTask", "JointLocationTask", "LocationTask", "Preempted", "RirVQVAETask",
    "SpeechVQVAETask", "Task", "Trainer", "TrainHistory", "check_flatten_handoff", "checkpoint_metadata",
    "fit_joint_recipe", "graft_pretrained", "make_task", "resolved_vq_flatten", "run_pipeline", "run_stage",
    "stage_seed",
]
