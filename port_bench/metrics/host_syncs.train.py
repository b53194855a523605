"""The runtime calls that block the host on the card (a synchronise, a
copy that is not asynchronous) inside the program's ``train.sample`` and
``train.step`` spans, per step of the traced window: the sampler's index
copy, the jitter's decisions, each quantizer's ``bincount``.
Arithmetic: ``harness/spans.py:per_unit``."""

from harness.spans import is_sync, per_unit

# the program's spans around a step's sampling and its step
SPANS = ("train.sample", "train.step")


def read(run):
    return per_unit(run, SPANS, is_sync)
