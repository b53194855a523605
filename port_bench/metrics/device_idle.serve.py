"""The traced serving window's share in which the card ran nothing.
Arithmetic: ``harness/readers.py:device_idle``."""

from harness.readers import device_idle


def read(run):
    return device_idle(run)
