"""The 95th percentile of every served call's latency in the window.
Arithmetic: ``harness/readers.py:p95_ms``."""

from harness.readers import p95_ms


def read(run):
    return p95_ms(run)
