"""Length-preserving 1-D conv and dense layers.

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/conv.py`` (``Conv1d``,
``Dense``). The JAX package runs channels-last; here the layout is torch's
own channels-first ``(B, C, L)``, which is also the public layout of both
packages. Parameters are named ``weight`` / ``bias`` with torch's shapes
(conv ``(out, in, k)``, dense ``(out, in)``) so the modules carry the
reference's state-dict keys.

``ConvTranspose1d`` is a real transposed convolution with torch's weight
layout ``(in, out, k)``. The JAX package implements the stride-1 transposed
conv as a plain conv with its own kernel ``(k, in, out)``; the two are the same
function when the port's weight is that kernel flipped along k with in and
out swapped (JAX ``eval/torch_export.py:41-44``, ``eval/weights.py`` here).

``compute_dtype`` (None for float32, or ``torch.bfloat16``) is flax's ``dtype``
on ``nn.Conv`` (JAX ``ops/conv.py:57-66``): the input and the weight are cast
to it, the convolution runs without its bias, the bias cast to it is added
after, and the output keeps it; the parameters stay float32. The bias is not
fused into the convolution: flax rounds the convolution's output to bf16 and
then adds the bf16 bias, and a fused bias rounds once, which moves the result
farther from JAX's bf16 than JAX's bf16 lies from its float32 (two roundings
are the reference's). Where the work runs follows the tensor: on a CUDA tensor
cuDNN's bf16 convolution; on a CPU tensor the form XLA-CPU computes, the
operands rounded to bf16, the convolution in float32 and its output rounded to
bf16 (bitwise JAX's on the tests' inputs; torch's native CPU bf16
convolution lies about one ulp of the maximum away). ``Dense`` has no
compute dtype: the location head stays float32, as JAX's does
(``models/location.py:26-30``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import kaiming_uniform_relu_, torch_default_

__all__ = ["Conv1d", "ConvTranspose1d", "Dense"]


def _conv(fn, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], padding: int,
          compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``fn`` (``F.conv1d`` or ``F.conv_transpose1d``) with flax's ``dtype``
    semantics (see the module docstring); float32 with the bias fused where
    ``compute_dtype`` is None."""
    if compute_dtype is None:
        return fn(x, weight, bias, padding=padding)
    x, weight = x.to(compute_dtype), weight.to(compute_dtype)
    if x.device.type == "cpu":
        y = fn(x.float(), weight.float(), padding=padding).to(compute_dtype)
    else:
        y = fn(x, weight, padding=padding)
    return y if bias is None else y + bias.to(compute_dtype)[:, None]


class Conv1d(nn.Module):
    """Stride-1 1-D convolution ``(B, C_in, L) -> (B, C_out, L)``, in
    ``compute_dtype`` where one is given.

    ``init_mode="kaiming"`` is the reference's explicit kaiming-uniform relu
    init; ``"torch_default"`` is torch's module default. The bias always takes
    torch's default init."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: int = 1,
        bias: bool = True,
        init_mode: str = "kaiming",
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if init_mode not in ("kaiming", "torch_default"):
            raise ValueError(f"unknown init_mode {init_mode!r}")
        self.padding = padding
        self.compute_dtype = compute_dtype
        fan_in = kernel_size * in_channels
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        init = kaiming_uniform_relu_ if init_mode == "kaiming" else torch_default_
        init(self.weight, fan_in, generator)
        if bias:
            self.bias = nn.Parameter(torch_default_(torch.empty(out_channels), fan_in, generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(F.conv1d, x, self.weight, self.bias, self.padding, self.compute_dtype)


class ConvTranspose1d(nn.Module):
    """Stride-1 transposed convolution ``(B, C_in, L) -> (B, C_out, L)``,
    weight ``(in, out, k)`` (deconvolutional_decoder.py:36-61), in
    ``compute_dtype`` where one is given.

    Init draws from the JAX module's distribution, whose kernel is that of a
    plain conv: kaiming-uniform weight and torch-default bias, both with
    ``fan_in = k * in_channels``. (torch's own ConvTranspose1d takes its fan-in
    from ``out * k``, which is not the JAX package's.)"""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: int = 1,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.padding = padding
        self.compute_dtype = compute_dtype
        fan_in = kernel_size * in_channels
        self.weight = nn.Parameter(
            kaiming_uniform_relu_(torch.empty(in_channels, out_channels, kernel_size), fan_in, generator)
        )
        self.bias = nn.Parameter(torch_default_(torch.empty(out_channels), fan_in, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(F.conv_transpose1d, x, self.weight, self.bias, self.padding, self.compute_dtype)


class Dense(nn.Module):
    """Linear layer with torch's default init (location_model.py:10-18)."""

    def __init__(self, in_features: int, out_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch_default_(torch.empty(out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch_default_(torch.empty(out_features), in_features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
