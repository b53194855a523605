"""Frames of every whole training step of the window over its seconds (resident sets).
Arithmetic: ``harness/readers.py:frames_per_s``."""

from harness.readers import frames_per_s


def read(run):
    return frames_per_s(run)
