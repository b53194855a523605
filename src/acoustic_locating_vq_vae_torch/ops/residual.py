"""Residual blocks and stacks (reference: vq_vae/modules/residual.py:31-66,
residual_stack.py:34-46).

Counterpart of ``acoustic_locating_vq_vae_tpu/ops/residual.py``, with the same
reference quirks as the compat defaults:

* **Tied stack weights** (``tied=True``): the reference builds its stack as
  ``nn.ModuleList([Residual(...)] * N)``, so all N layers are one module. The
  same list is built here, so the state dict holds a key for every index, all
  naming the same tensors.
* **conv_2 default init** (``compat_init=True``): conv_2 keeps torch's
  default init; conv_1 gets kaiming.
* **In-place ReLU mutates the skip** (``compat_inplace_relu=True``): the
  reference's first ``ReLU(inplace=True)`` turns its skip into ``relu(x)``, so
  the block computes ``relu(x) + conv2(relu(conv1(relu(x))))``. Here no ReLU
  is in place; the skip is computed explicitly.

``compute_dtype`` goes to every conv (JAX ``ops/residual.py:44-59,75-97``); the
ReLUs and the skips run in the dtype of what they receive, as in JAX.
``sequence_axis`` goes to the 3-tap conv (the 1x1 conv needs no halo). On the
model axis a block whose 3-tap conv is column-parallel and whose 1x1 conv is
row-parallel (the partition rules make both or neither) runs them as a
Megatron pair: the hidden channels stay split between them, and one sum over
the group ends the residual branch (``parallel/tensor.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv1d

__all__ = ["Residual", "ResidualStack"]


class Residual(nn.Module):
    """skip + Conv1x1(ReLU(Conv3(ReLU(x)))), both convs bias-free. ``_block``
    is the reference's ``Sequential(ReLU, conv_1, ReLU, conv_2)``."""

    def __init__(
        self,
        num_hiddens: int,
        num_residual_hiddens: int,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()
        self.compat_inplace_relu = compat_inplace_relu
        self._block = nn.Sequential(
            nn.ReLU(),
            Conv1d(num_hiddens, num_residual_hiddens, 3, padding=1, bias=False, generator=generator,
                   compute_dtype=compute_dtype, sequence_axis=sequence_axis),
            nn.ReLU(),
            Conv1d(
                num_residual_hiddens, num_hiddens, 1, padding=0, bias=False,
                init_mode="torch_default" if compat_init else "kaiming", generator=generator,
                compute_dtype=compute_dtype,
            ),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one ReLU feeds the block and the compat skip, as in JAX: in bf16 the
        # gradients of its two uses are summed (and rounded) before the ReLU
        rx = F.relu(x)
        conv_1, conv_2 = self._block[1], self._block[3]
        s1, s2 = getattr(conv_1.weight, "model_shard", None), getattr(conv_2.weight, "model_shard", None)
        if s1 is not None and s2 is not None and s1.dim == 0 and s2.dim == 1:
            # the Megatron pair: conv_1's output channels stay split, conv_2 sums them
            h = conv_1.sharded_forward(rx, leave=False)
            h = conv_2.sharded_forward(F.relu(h), enter=False)
        else:
            h = self._block[1:](rx)
        return (rx if self.compat_inplace_relu else x) + h


class ResidualStack(nn.Module):
    """N residual blocks followed by a final ReLU (residual_stack.py:43-46)."""

    def __init__(
        self,
        num_hiddens: int,
        num_residual_layers: int,
        num_residual_hiddens: int,
        tied: bool = True,
        compat_init: bool = True,
        compat_inplace_relu: bool = True,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
    ):
        super().__init__()

        def block():
            return Residual(num_hiddens, num_residual_hiddens, compat_init, compat_inplace_relu, generator,
                            compute_dtype, sequence_axis)

        if tied:
            self._layers = nn.ModuleList([block()] * num_residual_layers)
        else:
            self._layers = nn.ModuleList([block() for _ in range(num_residual_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self._layers:
            x = layer(x)
        return F.relu(x)
