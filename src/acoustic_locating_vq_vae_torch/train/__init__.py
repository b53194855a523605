"""Stage task specs and the single-VQ-VAE training loop."""

from .loop import Trainer, TrainHistory
from .tasks import JointLocationTask, LocationTask, RirVQVAETask, SpeechVQVAETask, Task

__all__ = [
    "JointLocationTask", "LocationTask", "RirVQVAETask", "SpeechVQVAETask", "Task",
    "Trainer", "TrainHistory",
]
