"""Frames of every whole on-the-fly training step of the window over its seconds.
Arithmetic: ``harness/readers.py:frames_per_s``."""

from harness.readers import frames_per_s


def read(run):
    return frames_per_s(run)
