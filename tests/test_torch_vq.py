"""The port's vector quantizer against the JAX package, on the same inputs
made with numpy (CPU): the assignment, the frozen forward, the codebook
gradient, the EMA statistics and the gradient and EMA modes of the module.
The CUDA kernels against their plain versions are in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acoustic_locating_vq_vae_tpu import ops as jops
from acoustic_locating_vq_vae_tpu.ops.vq_pallas import codebook_stats_pallas, nearest_codebook_pallas
from acoustic_locating_vq_vae_torch.ops import vq
from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda

# the shapes of tests/test_vq_pallas.py: aligned speech geometry, everything
# ragged, RIR geometry, row and codebook padding
SHAPES = [(512, 128, 1024), (100, 4, 16), (1000, 64, 1024), (513, 128, 100)]
# what the CUDA kernel's branches are held to: D off its 16-byte pieces and
# above its resident x tile, K below one code tile, rows over several row tiles
KERNEL_SHAPES = [(300, 129, 40), (200, 64, 16), (300, 6, 1024), (700, 256, 130)]


def _inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((k, d)).astype(np.float32),
    )


@pytest.mark.parametrize("n,d,k", SHAPES + KERNEL_SHAPES)
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


@pytest.mark.parametrize("n", [200, 1608], ids=["one_row_tile", "serving_b8"])
def test_duplicated_codebook_rows_take_the_lower_index(n):
    """Every code appears twice, the copy in the upper half: equal scores go
    to the lower index on every row, in the plain version as in Pallas."""
    x, half = _inputs(n, 64, 512, seed=7)
    cb = np.concatenate([half, half])
    e2 = torch.from_numpy((cb * cb).sum(1))
    idx = vq.nearest_indices(torch.from_numpy(x), torch.from_numpy(cb), e2)
    idx_p, _ = nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(cb))
    assert int(idx.max()) < 512
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_p))
    np.testing.assert_array_equal(idx.numpy(), vq.nearest_codebook(torch.from_numpy(x), torch.from_numpy(half))[0].numpy())


@pytest.mark.parametrize("minus_zero", [False, True], ids=["plus_zero", "minus_zero"])
def test_zero_scores_tie_toward_the_lower_index(minus_zero):
    """A row of zeros against two zero codebook rows scores 0.0 on both; with
    the later one's squared norm handed in as -0.0 the scores are +0.0 and
    -0.0, which are equal, so the lower index still wins."""
    rng = np.random.default_rng(8)
    cb = (rng.standard_normal((1024, 64)) + 3.0).astype(np.float32)
    cb[3] = 0.0
    cb[700] = 0.0
    x = np.zeros((130, 64), np.float32)
    e2 = torch.from_numpy((cb * cb).sum(1))
    if minus_zero:
        e2[700] = -0.0
        assert bool(torch.signbit(e2[700])) and not bool(torch.signbit(e2[3]))
    idx = vq.nearest_indices(torch.from_numpy(x), torch.from_numpy(cb), e2)
    idx_p, _ = nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(cb))
    np.testing.assert_array_equal(idx.numpy(), np.full(130, 3))
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


# ---------------------------------------------------------------- training paths

GRAD_SHAPES = [(300, 8, 32), (513, 128, 100)]


@pytest.mark.parametrize("n,d,k", GRAD_SHAPES)
def test_codebook_gradient_matches_jax(n, d, k):
    """The plain accumulation and the autograd path through ``assign``
    against jax.grad through the xla and the Pallas (interpret) assignment,
    rtol 1e-4 / atol 1e-5 (test_vq_pallas.py:34-49); the input gradient
    through the assignment is exactly zero."""
    x, cb = _inputs(n, d, k, seed=1)

    def loss(fn):
        return lambda cb_: jnp.sum(jnp.sin(fn(jnp.asarray(x), cb_)[1]) * fn(jnp.asarray(x), cb_)[1])

    want = {name: np.asarray(jax.grad(loss(fn))(jnp.asarray(cb)))
            for name, fn in (("xla", jops.nearest_codebook), ("pallas", nearest_codebook_pallas))}

    xt = torch.from_numpy(x).requires_grad_()
    cbt = torch.from_numpy(cb).requires_grad_()
    idx, q = vq.assign(xt, cbt)
    (torch.sin(q) * q).sum().backward()
    plain = vq.codebook_grad_plain(idx, (torch.sin(q) + q * torch.cos(q)).detach(), k)
    for name, w in want.items():
        np.testing.assert_allclose(cbt.grad.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(plain.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)
    assert xt.grad is None  # autograd's zero: the backward makes no (N, D) tensor for it


@pytest.mark.parametrize("n,d,k", GRAD_SHAPES)
def test_codebook_stats_match_pallas(n, d, k):
    """Counts exact, sums rtol 1e-5 against codebook_stats_pallas."""
    x, _ = _inputs(n, d, k, seed=2)
    idx = np.random.default_rng(3).integers(0, k, n).astype(np.int32)
    counts_j, sums_j = codebook_stats_pallas(jnp.asarray(idx), jnp.asarray(x), k)
    counts, sums = vq.codebook_stats(torch.from_numpy(idx), torch.from_numpy(x), k)
    assert counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5, atol=1e-6)


def _skewed_indices(kind, n, k, rng):
    """Code ids as early training gives them: few codes in use."""
    if kind == "one_code":
        return np.full(n, k // 2, np.int32)
    used = rng.choice(k, 32, replace=False)
    return used[rng.integers(0, 32, n)].astype(np.int32)


@pytest.mark.parametrize("n,d,k", [(2000, 16, 1024), (700, 129, 100)])
@pytest.mark.parametrize("kind", ["32_codes", "one_code"])
def test_codebook_accumulation_on_few_codes_matches_pallas(kind, n, d, k):
    """32 codes or one code in use: the plain gradient and statistics against
    codebook_stats_pallas, counts exact, sums rtol 1e-5 (atol 1e-5: a sum of
    up to 2000 FP32 rows in another order)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = _skewed_indices(kind, n, k, rng)
    counts_j, sums_j = codebook_stats_pallas(jnp.asarray(idx), jnp.asarray(x), k)
    counts, sums = vq.codebook_stats_plain(torch.from_numpy(idx), torch.from_numpy(x), k)
    grad = vq.codebook_grad_plain(torch.from_numpy(idx), torch.from_numpy(x), k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert int((counts > 0).sum()) == (1 if kind == "one_code" else 32)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(sums_j), rtol=1e-5, atol=1e-5)


def _vq_inputs(seed=4):
    rng = np.random.default_rng(seed)
    k, d = 32, 8
    x = rng.standard_normal((3, 40, d)).astype(np.float32)
    cb = x.reshape(-1, d)[rng.choice(120, k, replace=False)] + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    return k, d, x, np.ascontiguousarray(cb), w


def test_vq_gradient_mode_matches_jax():
    """train_vq=True: loss, straight-through output, and the gradients of
    ``loss + sum(w * quantized)`` in the codebook and in the inputs."""
    k, d, x, cb, w = _vq_inputs()
    jvq = jops.VectorQuantizer(num_embeddings=k, embedding_dim=d, commitment_cost=0.25)

    def f(cb_, x_):
        out = jvq.apply({"params": {"codebook": cb_}}, x_, train_vq=True)
        return out.loss + jnp.sum(jnp.asarray(w) * out.quantized), out

    (_, out_j), (g_cb, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(cb), jnp.asarray(x))

    tvq = vq.VectorQuantizer(k, d, 0.25)
    tvq.load_state_dict({"_embedding.weight": torch.from_numpy(cb)})
    xt = torch.from_numpy(x).requires_grad_()
    out = tvq(xt)
    (out.loss + (torch.from_numpy(w) * out.quantized).sum()).backward()
    np.testing.assert_allclose(out.loss.item(), float(out_j.loss), rtol=1e-5)
    np.testing.assert_allclose(out.quantized.detach().numpy(), np.asarray(out_j.quantized), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvq._embedding.weight.grad.numpy(), np.asarray(g_cb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-4, atol=1e-5)

    # frozen: the same loss value and no codebook gradient
    tvq.zero_grad()
    frozen = tvq(torch.from_numpy(x).requires_grad_(), train_vq=False)
    np.testing.assert_allclose(frozen.loss.item(), out.loss.item(), rtol=1e-6)
    (frozen.loss + frozen.quantized.sum()).backward()
    assert tvq._embedding.weight.grad is None


@pytest.mark.parametrize("reset", [0.0, 1.0], ids=["no_reset", "reset"])
def test_vq_ema_mode_matches_jax(reset):
    """EMA mode on a training step: loss (commitment only), straight-through
    output and the updated codebook, counts and sums; with a reset threshold
    some codes restart from batch rows. No update in eval mode or with
    train_vq=False."""
    k, d, x, cb, _ = _vq_inputs(5)
    counts0 = np.random.default_rng(6).uniform(0.2, 3.0, k).astype(np.float32)
    sums0 = cb * counts0[:, None]
    jvq = jops.VectorQuantizer(num_embeddings=k, embedding_dim=d, commitment_cost=0.25, ema=True,
                               ema_reset_threshold=reset)
    stats = {"codebook": cb, "ema_counts": counts0, "ema_sums": sums0}
    out_j, mutated = jvq.apply({"vq_stats": stats}, jnp.asarray(x), train_vq=True, mutable=["vq_stats"])
    new = jax.tree_util.tree_map(np.asarray, mutated["vq_stats"])
    if reset:
        assert (counts0 * 0.99 < reset).any()

    tvq = vq.VectorQuantizer(k, d, 0.25, ema=True, ema_reset_threshold=reset)
    tvq.load_state_dict({"_embedding.weight": torch.from_numpy(cb), "ema_counts": torch.from_numpy(counts0),
                         "ema_sums": torch.from_numpy(sums0)})
    assert list(tvq.parameters()) == []
    tvq.eval()
    tvq(torch.from_numpy(x))
    tvq.train()
    tvq(torch.from_numpy(x), train_vq=False)
    np.testing.assert_array_equal(tvq._embedding.weight.numpy(), cb)
    out = tvq(torch.from_numpy(x))
    np.testing.assert_allclose(out.loss.item(), float(out_j.loss), rtol=1e-5)
    np.testing.assert_allclose(out.quantized.numpy(), np.asarray(out_j.quantized), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvq.ema_counts.numpy(), new["ema_counts"], rtol=1e-6)
    np.testing.assert_allclose(tvq.ema_sums.numpy(), new["ema_sums"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvq._embedding.weight.numpy(), new["codebook"], rtol=1e-5, atol=1e-6)
