"""Samples of every served call of the window over its seconds.
Arithmetic: ``harness/readers.py:samples_per_s``."""

from harness.readers import samples_per_s


def read(run):
    return samples_per_s(run)
