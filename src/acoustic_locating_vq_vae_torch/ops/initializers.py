"""Weight initializers matching the reference's torch init choices.

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/initializers.py``. The
reference uses ``kaiming_uniform_(w, a=0, mode="fan_in", nonlinearity="relu")``
on most convs and leaves torch's default init on ``Residual.conv_2`` and on
every Linear layer. Each function fills a tensor in place from an explicit
``torch.Generator`` (None draws from torch's global generator), so full-width
weights can be made from a seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["kaiming_uniform_relu_", "torch_default_", "uniform_"]


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-bound, bound) in place."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def kaiming_uniform_relu_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-sqrt(6/fan_in), sqrt(6/fan_in)): kaiming uniform, fan_in, relu gain."""
    return uniform_(t, math.sqrt(6.0 / fan_in), generator)


def torch_default_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch's default Conv/Linear weight and bias init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return uniform_(t, 1.0 / math.sqrt(fan_in), generator)
