"""1-D conv, transposed conv and dense layers.

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

Both convs default to stride 1 and length-preserving zero padding, the VQ-VAE's
layers. The neural codec's layers (``models/encodec.py``) add what EnCodec's
``EncodecConv1d`` / ``EncodecConvTranspose1d`` do (transformers'
``modeling_encodec.py``): ``stride``, ``dilation``, ``padding="causal"`` (the
conv reflect-pads ``k_eff - stride`` samples on the left and, on the right, the
few that complete its last frame; the transposed conv trims its ``k - stride``
trailing samples), and ``weight_norm``: the state dict holds the
pair ``weight_g`` / ``weight_v`` and ``weight`` is ``g * v / ||v||`` (norm over
every dim but the first, ``torch._weight_norm``), folded once at construction and
again each time a state dict is loaded, never per call. Stride-1 layers run
exactly the calls they ran before these options.

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

Two kinds of sharding, both switched on from outside the module:

* ``sequence_axis`` (a mesh axis name, JAX ``ops/conv.py:43-60``): the conv
  runs on a time shard, exchanges its (k-1)/2 edge frames with its neighbours
  on that axis of the mesh that :func:`..models.conv_vqvae.sequence_sharding`
  installs (``mesh``) and convolves VALID; the SAME stride-1 conv of the whole
  sequence. Without a mesh, or on an axis of one rank, it is the plain conv.
* a weight split over the model axis (``parallel.shard_model`` gives it a
  ``model_shard``): column-parallel where its out-features are split, the
  rank's block of the output channels gathered over the group; row-parallel
  where its in-features are split, the rank's block of the input channels in
  and the partial outputs summed over the group; the bias after the
  collective (``parallel/tensor.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import kaiming_uniform_relu_, torch_default_

__all__ = ["Conv1d", "ConvTranspose1d", "Dense"]


def _conv(fn, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], padding: int,
          compute_dtype: Optional[torch.dtype], **strides) -> torch.Tensor:
    """``fn`` (``F.conv1d`` or ``F.conv_transpose1d``) with flax's ``dtype``
    semantics (see the module docstring); float32 with the bias fused where
    ``compute_dtype`` is None. ``strides``: a codec conv's ``stride`` and
    ``dilation`` (none for a stride-1 conv)."""
    kw = dict(padding=padding, **strides)
    if compute_dtype is None:
        return fn(x, weight, bias, **kw)
    x, weight = x.to(compute_dtype), weight.to(compute_dtype)
    if x.device.type == "cpu":
        y = fn(x.float(), weight.float(), **kw).to(compute_dtype)
    else:
        y = fn(x, weight, **kw)
    return y if bias is None else y + bias.to(compute_dtype)[:, None]


def _causal_pad(x: torch.Tensor, kernel_size: int, stride: int, dilation: int) -> torch.Tensor:
    """EnCodec's causal reflect padding of a conv's input
    (``EncodecConv1d.forward`` with ``_get_extra_padding_for_conv1d`` and
    ``_pad1d``): ``k_eff - stride`` samples on the left, and on the right the
    ``(-L) mod stride`` that make the length a whole number of frames, so the
    output has ``ceil(L / stride)`` of them. An input no longer than the
    padding gets zeros on the right first, cut off after."""
    k_eff = (kernel_size - 1) * dilation + 1
    left, right = k_eff - stride, (-x.shape[-1]) % stride
    extra = max(0, max(left, right) - x.shape[-1] + 1)
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


def _fold(module: nn.Module, *_) -> None:
    """``weight = g * v / ||v||`` from the module's pair (a load's post hook)."""
    with torch.no_grad():
        module.weight = torch._weight_norm(module.weight_v, module.weight_g, 0)


def _weight_normed(module: nn.Module) -> None:
    """Replace ``module.weight`` by the pair ``weight_g`` (its norm over
    every dim but the first, as ``weight_norm`` initialises it) and
    ``weight_v``, with ``weight`` a non-persistent buffer folded from them."""
    v = module.weight.detach()
    del module.weight
    module.weight_g = nn.Parameter(torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True))
    module.weight_v = nn.Parameter(v)
    module.register_buffer("weight", None, persistent=False)
    _fold(module)
    module.register_load_state_dict_post_hook(_fold)


class _Sharded(nn.Module):
    """What :class:`Conv1d`, :class:`ConvTranspose1d` and :class:`Dense`
    share: the optional halo of a time shard and the model-axis split of the
    weight. ``OUT_DIM`` is the weight's out-features dim, ``CHANNELS`` the
    input's feature dim."""

    OUT_DIM = 0
    CHANNELS = 1
    sequence_axis: Optional[str] = None
    mesh = None  # the process mesh whose sequence axis a time shard runs on
    padding = 0

    def _local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The layer on ``x`` with the rank's weight block (the whole weight
        where it is not split) and ``bias`` (None: none)."""
        raise NotImplementedError

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _halo(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(the input, the padding the conv then takes): on a sharded time
        axis the input with its neighbours' frames and no padding."""
        if self.sequence_axis is None or self.padding == 0 or self.mesh is None \
                or self.mesh.axis(self.sequence_axis)[2] == 1:
            return x, self.padding
        # imported here: loading an exported artifact imports the operator's module alone, not parallel/
        from ..parallel.sequence import halo_exchange

        return halo_exchange(x, self.padding, self.mesh, self.sequence_axis), 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sharded_forward(x)

    def sharded_forward(self, x: torch.Tensor, enter: bool = True, leave: bool = True) -> torch.Tensor:
        """The layer, on a split weight Megatron-style: ``enter`` marks the
        replicated input (and cuts a row-parallel layer's block of it),
        ``leave`` gathers a column-parallel layer's output channels or sums a
        row-parallel layer's partial outputs, and adds the bias. A residual
        block leaves its column-parallel 3-tap conv and enters its
        row-parallel 1x1 conv without either."""
        shard = getattr(self.weight, "model_shard", None)
        if shard is None:
            return self._local(x, self.bias)
        from ..parallel.tensor import model_copy, model_gather, model_reduce

        row = shard.dim != self.OUT_DIM
        if enter:
            x = model_copy(x, shard.mesh)
            if row:
                x = x.narrow(self.CHANNELS, shard.lo, shard.block)
        y = self._local(x, None)
        if not leave:
            return y
        y = model_reduce(y, shard.mesh) if row else model_gather(y, shard.mesh, self.CHANNELS)
        return y if self.bias is None else self._add_bias(y)


def _check_same(sequence_axis: Optional[str], kernel_size: int, padding, stride: int = 1, dilation: int = 1) -> None:
    """A time shard's halo is the (k-1)/2 frames of a stride-1 SAME conv: any
    other conv on a sequence axis is refused here, not computed wrong."""
    if sequence_axis is None:
        return
    if stride != 1 or dilation != 1 or not isinstance(padding, int) or (padding and padding != (kernel_size - 1) // 2):
        raise ValueError("sequence_axis requires stride-1 SAME convs")


def _check_padding(padding, stride: int) -> None:
    if not (padding == "causal" or (isinstance(padding, int) and padding >= 0)):
        raise ValueError(f"padding must be a non-negative int or 'causal', got {padding!r}")
    if stride < 1:
        raise ValueError(f"stride must be positive, got {stride}")


class Conv1d(_Sharded):
    """1-D convolution ``(B, C_in, L) -> (B, C_out, L')``, in
    ``compute_dtype`` where one is given: stride 1 and length-preserving by
    default, ``L' = ceil(L / stride)`` with ``padding="causal"`` (see the
    module docstring).

    ``init_mode="kaiming"`` is the reference's explicit kaiming-uniform relu
    init; ``"torch_default"`` is torch's module default. The bias always takes
    torch's default init."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: Union[int, str] = 1,
        bias: bool = True,
        init_mode: str = "kaiming",
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
        stride: int = 1,
        dilation: int = 1,
        weight_norm: bool = False,
    ):
        super().__init__()
        if init_mode not in ("kaiming", "torch_default"):
            raise ValueError(f"unknown init_mode {init_mode!r}")
        _check_padding(padding, stride)
        _check_same(sequence_axis, kernel_size, padding, stride, dilation)
        self.padding, self.stride, self.dilation = padding, stride, dilation
        self.kernel_size = kernel_size
        self._strides = {} if stride == dilation == 1 else dict(stride=stride, dilation=dilation)
        self.compute_dtype = compute_dtype
        self.sequence_axis = sequence_axis
        fan_in = kernel_size * in_channels
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        init = kaiming_uniform_relu_ if init_mode == "kaiming" else torch_default_
        init(self.weight, fan_in, generator)
        if bias:
            self.bias = nn.Parameter(torch_default_(torch.empty(out_channels), fan_in, generator))
        else:
            self.register_parameter("bias", None)
        if weight_norm:
            _weight_normed(self)

    def _local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.padding == "causal":
            x, padding = _causal_pad(x, self.kernel_size, self.stride, self.dilation), 0
        else:
            x, padding = self._halo(x)
        return _conv(F.conv1d, x, self.weight, bias, padding, self.compute_dtype, **self._strides)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return y + (self.bias if dt is None else self.bias.to(dt))[:, None]


class ConvTranspose1d(_Sharded):
    """Transposed convolution ``(B, C_in, L) -> (B, C_out, L)``, weight
    ``(in, out, k)`` (deconvolutional_decoder.py:36-61), in ``compute_dtype``
    where one is given: stride 1 by default; with ``padding="causal"``,
    ``(B, C_in, L) -> (B, C_out, L * stride)`` (see the module docstring).

    Init draws from the JAX module's distribution, whose kernel is that of a
    plain conv: kaiming-uniform weight and torch-default bias, both with
    ``fan_in = k * in_channels``. (torch's own ConvTranspose1d takes its fan-in
    from ``out * k``, which is not the JAX package's.) On a time shard the
    haloed input's transposed conv crops the halo with its padding."""

    OUT_DIM = 1

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: Union[int, str] = 1,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        sequence_axis: Optional[str] = None,
        stride: int = 1,
        weight_norm: bool = False,
    ):
        super().__init__()
        _check_padding(padding, stride)
        _check_same(sequence_axis, kernel_size, padding, stride)
        self.padding, self.stride, self.kernel_size = padding, stride, kernel_size
        self.compute_dtype = compute_dtype
        self.sequence_axis = sequence_axis
        fan_in = kernel_size * in_channels
        self.weight = nn.Parameter(
            kaiming_uniform_relu_(torch.empty(in_channels, out_channels, kernel_size), fan_in, generator)
        )
        self.bias = nn.Parameter(torch_default_(torch.empty(out_channels), fan_in, generator))
        if weight_norm:
            _weight_normed(self)

    def _local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.padding == "causal":  # EnCodec's trim: the k - stride trailing samples
            y = _conv(F.conv_transpose1d, x, self.weight, bias, 0, self.compute_dtype, stride=self.stride)
            return y[..., : y.shape[-1] - (self.kernel_size - self.stride)]
        xh, padding = self._halo(x)
        # the halo frames widen the transposed conv's output as much as padding narrows it
        padding = self.padding if xh is x else 2 * self.padding
        return _conv(F.conv_transpose1d, xh, self.weight, bias, padding, self.compute_dtype)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return y + (self.bias if dt is None else self.bias.to(dt))[:, None]


class Dense(_Sharded):
    """Linear layer with torch's default init (location_model.py:10-18);
    row- or column-parallel on a weight split over the model axis."""

    CHANNELS = -1

    def __init__(self, in_features: int, out_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch_default_(torch.empty(out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch_default_(torch.empty(out_features), in_features, generator))

    def _local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        return F.linear(x, self.weight, bias)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y + self.bias
