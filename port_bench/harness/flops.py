"""Operation and byte counts from the shapes alone, and the card's peaks.

The model FLOP count of the echoed step is ``bench_gpu.py``'s
(``_conv_flops``, ``echoed_step_model_tflops``: conv and VQ-matmul terms,
frozen parts forward once, a trained part forward plus its weight gradient
plus its data gradient), copied and split into layers here, with one
correction: the data gradient of the trained stack's first layer, whose
input needs none, is not counted, since no kernel computes it. The joint
localizer's served call counts its encoder, the assignment's cross term and
the head's matrix products.

``vq_nearest_bound_s``: the least time of one assignment call (PERF.md's
kernel table, the "ops" bound): 2·N·D·K operations at the FP32 peak against
x, the codebook and the ids read or written once at the HBM peak, the larger
of the two.
"""

from __future__ import annotations

from typing import List

# NVIDIA H100 SXM, dense, published: FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def conv_flops(b: int, length: int, cin: int, cout: int, k: int) -> float:
    """One stride-1, length-preserving 1-D convolution (or transposed one)."""
    return 2.0 * b * length * cin * cout * k


def stack_layers(b: int, length: int, h: int, rh: int, layers: int) -> List[float]:
    """A residual stack's convs, layer by layer (tied layers still run each)."""
    out = []
    for _ in range(layers):
        out += [conv_flops(b, length, h, rh, 3), conv_flops(b, length, rh, h, 1)]
    return out


def encoder_layers(b: int, length: int, br: dict) -> List[float]:
    """A VQ-VAE branch's encoder and pre-VQ conv."""
    h = br["num_hiddens"]
    return ([conv_flops(b, length, br["in_channels"], h, 3)]
            + stack_layers(b, length, h, br["num_residual_hiddens"], br["num_residual_layers"])
            + [conv_flops(b, length, h, br["embedding_dim"], 3)])


def decoder_layers(b: int, length: int, d: int, dec: dict) -> List[float]:
    """The decoder: its first conv, the stack and the three transposed convs."""
    h = dec["num_hiddens"]
    return ([conv_flops(b, length, d, h, 3)]
            + stack_layers(b, length, h, dec["num_residual_hiddens"], dec["num_residual_layers"])
            + [conv_flops(b, length, h, h, 3)] * 2 + [conv_flops(b, length, h, dec["out_channels"], 3)])


def vq_flops(rows: int, br: dict) -> float:
    """The assignment's cross term: rows x D x K multiply-adds."""
    return 2.0 * rows * br["embedding_dim"] * br["num_embeddings"]


def dense_flops(b: int, widths: List[int]) -> float:
    """A stack of dense layers of the given widths."""
    return sum(2.0 * b * widths[i] * widths[i + 1] for i in range(len(widths) - 1))


def trained(layers: List[float]) -> float:
    """Forward, weight gradient and data gradient of a trained stack whose
    first layer's input needs no gradient."""
    return 3.0 * sum(layers) - layers[0]


def vq_nearest_bound_s(n: int, d: int, k: int) -> float:
    """Least seconds of one nearest-codebook call of N rows of D over K codes."""
    ops = 2.0 * n * d * k
    nbytes = 4.0 * (n * d + k * d + n)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
