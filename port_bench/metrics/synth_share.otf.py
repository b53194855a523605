"""The share of the card's busy time in kernels launched inside the
benchmark's span around Trainer.otf_batch (``loops/train.py``).
Arithmetic: ``harness/readers.py:share_under``."""

from harness.readers import share_under

# the span the training loop opens around the synthesis of a batch in a traced window
OPS = ("bench.otf_batch",)


def read(run):
    return share_under(run, OPS)
