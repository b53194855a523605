"""The served call's convs' share of their roofline in the traced window: the
kernels launched under the conv operator (layout transposes and bias adds
included); a served call runs no backward.
Arithmetic: ``harness/readers.py:conv_roofline``."""

from harness.readers import conv_roofline

# the host operations whose kernels are the layer's, outermost calls
OPS = ("aten::convolution",)


def read(run):
    return conv_roofline(run, OPS)
