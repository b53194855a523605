"""Stage task specs (inference part of the two localizer tasks)."""

from .tasks import JointLocationTask, LocationTask

__all__ = ["JointLocationTask", "LocationTask"]
