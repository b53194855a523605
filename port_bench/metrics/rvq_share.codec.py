"""The share of the card's busy time in kernels launched inside the
program's ``rvq.encode`` and ``rvq.decode`` spans (``ops/vq.py:
ResidualVectorQuantizer``: the chain of assignments and residuals, the
codebook rows' lookups and their sum) in the traced codec window.
Arithmetic: ``harness/readers.py:share_under``."""

from harness.readers import share_under

# the program's spans around the residual quantizer's encode and decode
OPS = ("rvq.encode", "rvq.decode")


def read(run):
    return share_under(run, OPS)
