"""The frozen branches' assignment calls' share of their bound in the traced
window.
Arithmetic: ``harness/readers.py:vq_nearest_roofline``."""

from harness.readers import vq_nearest_roofline

# the kernel of the operator vq_nearest (csrc/vq_nearest.cu), by the part of its name it always has
KERNEL = "vq_nearest_kernel"


def read(run):
    return vq_nearest_roofline(run, KERNEL)
