"""The port's vector-quantizer assignment and VectorQuantizer forward against
the JAX package, on the same inputs made with numpy (CPU). The CUDA kernel
against its plain version is in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acoustic_locating_vq_vae_tpu import ops as jops
from acoustic_locating_vq_vae_tpu.ops.vq_pallas import nearest_codebook_pallas
from acoustic_locating_vq_vae_torch.ops import vq
from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda

# the shapes of tests/test_vq_pallas.py: aligned speech geometry, everything
# ragged, RIR geometry, row and codebook padding
SHAPES = [(512, 128, 1024), (100, 4, 16), (1000, 64, 1024), (513, 128, 100)]


def _inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((k, d)).astype(np.float32),
    )


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_nearest_codebook_matches_jax(n, d, k):
    x, cb = _inputs(n, d, k)
    idx, q = vq.nearest_codebook(torch.from_numpy(x), torch.from_numpy(cb))
    for name, fn in (("xla", jops.nearest_codebook), ("pallas", nearest_codebook_pallas)):
        idx_j, q_j = fn(jnp.asarray(x), jnp.asarray(cb))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j), err_msg=name)
        np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-6, err_msg=name)


def test_ties_resolve_identically():
    """All codebook rows equal: every path picks the first index."""
    x = np.ones((8, 4), np.float32)
    cb = np.ones((6, 4), np.float32)
    idx, _ = vq.nearest_codebook(torch.from_numpy(x), torch.from_numpy(cb))
    idx_j, _ = jops.nearest_codebook(jnp.asarray(x), jnp.asarray(cb))
    idx_p, _ = nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(cb))
    np.testing.assert_array_equal(idx.numpy(), np.zeros(8))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_p))


def test_vector_quantizer_forward_matches_jax():
    """train_vq=False, need_encodings=True: loss, straight-through output and
    perplexity within rtol 1e-5; indices and one-hot exact; lookup inverts."""
    rng = np.random.default_rng(3)
    k, d = 32, 8
    x = rng.standard_normal((3, 40, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    jvq = jops.VectorQuantizer(num_embeddings=k, embedding_dim=d, commitment_cost=0.25)
    out_j = jvq.apply({"params": {"codebook": jnp.asarray(cb)}}, jnp.asarray(x), train_vq=False, need_encodings=True)

    tvq = vq.VectorQuantizer(k, d, 0.25)
    tvq.load_state_dict({"_embedding.weight": torch.from_numpy(cb)})
    out = tvq(torch.from_numpy(x), need_encodings=True)

    np.testing.assert_allclose(out.loss.item(), float(out_j.loss), rtol=1e-5)
    np.testing.assert_allclose(out.quantized.detach().numpy(), np.asarray(out_j.quantized), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.perplexity.item(), float(out_j.perplexity), rtol=1e-5)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(out_j.indices))
    np.testing.assert_array_equal(out.encodings.numpy(), np.asarray(out_j.encodings))
    assert out.quantized.shape == x.shape and out.encodings.shape == (3 * 40, k)
    np.testing.assert_array_equal(tvq.lookup(out.indices).detach().numpy(), cb[out.indices.numpy()])


def test_vector_quantizer_encodings_only_on_request():
    tvq = vq.VectorQuantizer(16, 4, 0.25, generator=torch.Generator().manual_seed(0))
    out = tvq(torch.randn(5, 4, generator=torch.Generator().manual_seed(1)))
    assert out.encodings is None
    w = tvq._embedding.weight.detach()
    assert w.shape == (16, 4) and float(w.abs().max()) <= 1.0 / 16


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: it raises."""
    x, cb = _inputs(10, 4, 6)
    x, cb = torch.from_numpy(x), torch.from_numpy(cb)
    before = nearest_indices_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        nearest_indices_cuda(x, cb, (cb * cb).sum(1))
    assert nearest_indices_cuda.launches == before


def test_assign_raises_off_cpu_and_cuda():
    x = torch.empty(4, 2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        vq.assign(x, torch.empty(3, 2, device="meta"))
