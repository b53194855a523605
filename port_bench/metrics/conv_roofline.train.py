"""The training step's convs' share of their roofline in the traced window:
the kernels launched under the conv operators, forward and backward (layout
transposes and bias adds included).
Arithmetic: ``harness/readers.py:conv_roofline``."""

from harness.readers import conv_roofline

# the host operations whose kernels are the layer's, outermost calls
OPS = ("aten::convolution", "aten::convolution_backward")


def read(run):
    return conv_roofline(run, OPS)
