"""The residual quantizer's assignment calls' share of their bound in the
traced codec window: one ``vq_nearest`` launch a stage, 32 a call at 24 kbps
(None where the launches are not the configuration's calls).
Arithmetic: ``harness/readers.py:vq_nearest_roofline``."""

from harness.readers import vq_nearest_roofline

# the kernel of the operator vq_nearest (csrc/vq_nearest.cu), by the part of its name it always has
KERNEL = "vq_nearest_kernel"


def read(run):
    return vq_nearest_roofline(run, KERNEL)
