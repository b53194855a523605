"""The share of the card's busy time in kernels launched inside the
program's ``synth.rir`` span (``data/synth.py:rirs_from_draws``: the
image-source lattice, the tap build, the high-pass) in the traced
on-the-fly window. Arithmetic: ``harness/readers.py:share_under``."""

from harness.readers import share_under

# the program's span around the RIRs of a synthesized batch
OPS = ("synth.rir",)


def read(run):
    return share_under(run, OPS)
