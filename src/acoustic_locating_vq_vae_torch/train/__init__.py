"""Stage task specs, the stage handoff and the training loop."""

from .loop import Trainer, TrainHistory
from .tasks import (
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
    "EchoedSpeechTask", "EncoderFinetuneTask", "JointLocationTask", "LocationTask", "RirVQVAETask",
    "SpeechVQVAETask", "Task", "Trainer", "TrainHistory", "check_flatten_handoff", "graft_pretrained",
    "make_task", "resolved_vq_flatten",
]
