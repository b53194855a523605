"""The echoed step's model FLOPs over the window's seconds, as a share of the FP32 peak.
Arithmetic: ``harness/readers.py:mfu``."""

from harness.readers import mfu


def read(run):
    return mfu(run)
