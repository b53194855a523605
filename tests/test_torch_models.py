"""The port's conv stacks, encoder, transposed conv, decoder,
ConvolutionalVQVAE and location head against the JAX package, with the JAX weights carried across
by ``params_from_jax`` and the same numpy inputs (CPU, RIR-branch geometry at
width 1/16).

Convolution sums run in another order in XLA-CPU and torch-CPU, so floats
agree within rtol 1e-4 / atol 1e-5; code ids agree exactly for the fixed
seeds (the codebook is made of latent rows, so no row sits on a near tie)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import models as jmodels
from acoustic_locating_vq_vae_tpu import ops as jops
from acoustic_locating_vq_vae_torch.eval import params_from_jax
from acoustic_locating_vq_vae_torch.models import (
    ConvolutionalEncoder,
    ConvolutionalVQVAE,
    DeconvolutionalDecoder,
    LocationModule,
)
from acoustic_locating_vq_vae_torch.ops import ConvTranspose1d, ResidualStack
from acoustic_locating_vq_vae_torch.ops.initializers import kaiming_uniform_relu_, torch_default_

# the RIR branch at width_scale 1/16: 500 frames as channels, length 201
C_IN, L, H, RH, D, K = 500, 201, 64, 4, 4, 64
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(b, c, l, seed):
    return np.random.default_rng(seed).standard_normal((b, c, l)).astype(np.float32)


@pytest.mark.parametrize("tied,compat", [(True, True), (False, True), (True, False)])
def test_residual_stack_matches_jax(tied, compat):
    x = _x(2, 16, 30, 0)
    jstack = jops.ResidualStack(16, 2, 8, tied=tied, compat_inplace_relu=compat)
    xl = jnp.asarray(x.transpose(0, 2, 1))  # JAX runs channels-last
    p = _np(jstack.init(jax.random.PRNGKey(0), xl)["params"])
    want = np.asarray(jstack.apply({"params": p}, xl)).transpose(0, 2, 1)

    stack = ResidualStack(16, 2, 8, tied=tied, compat_inplace_relu=compat)
    # the encoder's layout of the same tree: conv_1 unused, stack keys reused
    sd = params_from_jax({"conv_1": {"Conv_0": {"kernel": np.zeros((3, 1, 16))}}, "residual_stack": p})
    stack.load_state_dict({k[len("_residual_stack."):]: v for k, v in sd.items() if k.startswith("_residual_stack.")})
    got = stack(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if tied:
        assert stack._layers[0] is stack._layers[1]


def test_encoder_matches_jax():
    x = _x(2, C_IN, L, 1)
    jenc = jmodels.ConvolutionalEncoder(H, 2, RH)
    xl = jnp.asarray(x.transpose(0, 2, 1))
    p = _np(jenc.init(jax.random.PRNGKey(1), xl)["params"])
    want = np.asarray(jenc.apply({"params": p}, xl)).transpose(0, 2, 1)

    enc = ConvolutionalEncoder(C_IN, H, 2, RH)
    enc.load_state_dict(params_from_jax(p))
    np.testing.assert_allclose(enc(torch.from_numpy(x)).detach().numpy(), want, rtol=RTOL, atol=ATOL)


def _rir_pair(compat_vq_flatten):
    """A JAX RIR ConvolutionalVQVAE and the port's, on the same weights, with
    the codebook replaced by K pre-VQ latent rows of a separate batch."""
    jm = jmodels.ConvolutionalVQVAE(
        in_channels=C_IN, num_hiddens=H, embedding_dim=D, num_residual_layers=2,
        num_residual_hiddens=RH, commitment_cost=0.25, num_embeddings=K,
        use_jitter=False, out_channels=1, compat_vq_flatten=compat_vq_flatten,
    )
    p = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(_x(1, C_IN, L, 2)))["params"])
    tm = ConvolutionalVQVAE(
        C_IN, H, D, 2, RH, 0.25, K, compat_vq_flatten=compat_vq_flatten, use_jitter=False, out_channels=1,
    )
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        z = tm.pre_vq_latent(torch.from_numpy(_x(2, C_IN, L, 3)))
        rows = (z if compat_vq_flatten else z.transpose(1, 2)).reshape(-1, D).numpy()
        pick = np.random.default_rng(4).choice(rows.shape[0], K, replace=False)
        cb = np.ascontiguousarray(rows[pick])
        tm._vq._embedding.weight.copy_(torch.from_numpy(cb))
    p["_vq"]["codebook"] = cb
    return jm, p, tm


@pytest.mark.parametrize("compat_vq_flatten", [True, False], ids=["memory_order", "vectors"])
def test_vqvae_encode_half_matches_jax(compat_vq_flatten):
    jm, p, tm = _rir_pair(compat_vq_flatten)
    x = _x(3, C_IN, L, 5)
    v = {"params": p}
    loss_j, q_j, perp_j, enc_j = jm.apply(v, jnp.asarray(x), method=jm.get_latent_representation)
    codes_j = np.asarray(jm.apply(v, jnp.asarray(x), method=jm.get_latent_codes))

    with torch.no_grad():
        loss, q, perp, enc = tm.get_latent_representation(torch.from_numpy(x))
        codes = tm.get_latent_codes(torch.from_numpy(x))
        q_codes = tm.codes_to_latent(codes)
    assert q.shape == (3, D, L) and codes.shape == (3, L)
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(enc_j))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(perp.item(), float(perp_j), rtol=RTOL)
    # exact codebook rows, equal to the straight-through latent up to rounding
    q_codes_j = jm.apply(v, jnp.asarray(codes_j), method=jm.codes_to_latent)
    np.testing.assert_array_equal(q_codes.numpy(), np.asarray(q_codes_j))
    np.testing.assert_allclose(q_codes.numpy(), q.numpy(), rtol=RTOL, atol=ATOL)


def test_location_module_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, L, D)).astype(np.float32)
    jloc = jmodels.LocationModule(encoder_output_dim=L, num_hiddens=D, output_dim=3)
    p = _np(jloc.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    want = np.asarray(jloc.apply({"params": p}, jnp.asarray(x)))
    loc = LocationModule(L, D, 3)
    loc.load_state_dict(params_from_jax(p))
    np.testing.assert_allclose(loc(torch.from_numpy(x)).detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_params_from_jax_keys_fill_the_port_modules():
    """Every key of the port's state dict comes across, and the tied block's
    one set of weights lands at each layer index."""
    jm, p, tm = _rir_pair(False)
    sd = params_from_jax(p)
    assert set(sd) == set(tm.state_dict())
    blk = "_encoder._residual_stack._layers.{}._block.1.weight"
    assert torch.equal(sd[blk.format(0)], sd[blk.format(1)])
    kernel = np.asarray(p["_encoder"]["conv_1"]["Conv_0"]["kernel"])  # (k, in, out)
    np.testing.assert_array_equal(sd["_encoder._conv_1.weight"].numpy(), kernel.transpose(2, 1, 0))
    with pytest.raises(ValueError, match="unrecognised"):
        params_from_jax({"something": {}})


def test_initializers_draw_from_the_generator():
    def draw(seed):
        t = torch.empty(64, 32, 3)
        return kaiming_uniform_relu_(t, 96, torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= (6.0 / 96) ** 0.5
    d = torch_default_(torch.empty(1000), 100, torch.Generator().manual_seed(0))
    assert float(d.abs().max()) <= 0.1 and float(d.abs().max()) > 0.09


def test_conv_transpose_matches_jax():
    """The port's real transposed conv with weight = JAX kernel flipped
    along k, in/out swapped equals the JAX stride-1 ConvTranspose1d; init
    draws kaiming-uniform with fan_in = 3 * in_channels."""
    x = _x(2, 12, 30, 7)
    jct = jops.ConvTranspose1d(9)
    xl = jnp.asarray(x.transpose(0, 2, 1))
    p = _np(jct.init(jax.random.PRNGKey(5), xl)["params"])
    want = np.asarray(jct.apply({"params": p}, xl)).transpose(0, 2, 1)
    ct = ConvTranspose1d(12, 9, generator=torch.Generator().manual_seed(0))
    assert ct.weight.shape == (12, 9, 3)
    w_max, b_max = float(ct.weight.detach().abs().max()), float(ct.bias.detach().abs().max())
    assert 0.35 < w_max <= (6.0 / 36) ** 0.5 and b_max <= 36 ** -0.5
    kernel = p["Conv_0"]["kernel"]  # (k, in, out)
    ct.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(kernel[::-1].transpose(1, 2, 0))),
                        "bias": torch.from_numpy(np.array(p["Conv_0"]["bias"]))})
    np.testing.assert_allclose(ct(torch.from_numpy(x)).detach().numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_decoder_matches_jax(tied):
    """The decoder (jitter off at train=False) through params_from_jax of a
    bare ``_decoder`` tree, and its input gradient."""
    x = _x(2, D, 40, 8)
    jdec = jmodels.DeconvolutionalDecoder(out_channels=7, num_hiddens=16, num_residual_layers=3,
                                          num_residual_hiddens=8, tied=tied)
    xl = jnp.asarray(x.transpose(0, 2, 1))
    p = _np(jdec.init({"params": jax.random.PRNGKey(6), "jitter": jax.random.PRNGKey(7)}, xl)["params"])
    f = lambda v: jdec.apply({"params": p}, v, train=False)
    want = np.asarray(f(xl)).transpose(0, 2, 1)
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(f(v) ** 2))(xl)).transpose(0, 2, 1)

    dec = DeconvolutionalDecoder(D, 7, 16, 3, 8, tied=tied)
    sd = params_from_jax(p, num_residual_layers=3)
    assert set(sd) == set(dec.state_dict())
    dec.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_()
    out = dec(xt, train=False)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)


def test_params_from_jax_carries_an_ema_model():
    """An EMA model's codebook, counts and sums come from its vq_stats; the
    codebook is a buffer, so no optimizer sees it."""
    jm = jmodels.ConvolutionalVQVAE(
        in_channels=C_IN, num_hiddens=H, embedding_dim=D, num_residual_layers=2,
        num_residual_hiddens=RH, commitment_cost=0.25, num_embeddings=K,
        use_jitter=False, out_channels=1, vq_ema=True,
    )
    v = _np(jm.init(jax.random.PRNGKey(9), jnp.asarray(_x(1, C_IN, L, 9))))
    tm = ConvolutionalVQVAE(C_IN, H, D, 2, RH, 0.25, K, use_jitter=False, out_channels=1, vq_ema=True)
    sd = params_from_jax(v["params"], vq_stats=v["vq_stats"])
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    np.testing.assert_array_equal(tm._vq.ema_sums.numpy(), v["vq_stats"]["_vq"]["ema_sums"])
    np.testing.assert_array_equal(tm._vq._embedding.weight.numpy(), v["vq_stats"]["_vq"]["codebook"])
    assert "_vq._embedding.weight" not in dict(tm.named_parameters())
    dec_t = sd["_decoder._conv_trans_3.weight"]
    kernel = v["params"]["_decoder"]["conv_trans_3"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(dec_t.numpy(), kernel[::-1].transpose(1, 2, 0))


@pytest.mark.parametrize("pooling", [False, True], ids=["per_step", "average_pooling"])
def test_vqvae_forward_matches_jax(pooling):
    """The whole VQ-VAE at train=False (no jitter), with and without the
    encoder's mean over time: loss, reconstruction and perplexity."""
    jm = jmodels.ConvolutionalVQVAE(
        in_channels=12, num_hiddens=16, embedding_dim=D, num_residual_layers=2, num_residual_hiddens=8,
        commitment_cost=0.25, num_embeddings=8, encoder_average_pooling=pooling,
    )
    x = _x(3, 12, 20, 10)
    rngs = {"params": jax.random.PRNGKey(11), "jitter": jax.random.PRNGKey(12)}
    p = _np(jm.init(rngs, jnp.asarray(x))["params"])
    p["_vq"]["codebook"] = np.random.default_rng(13).standard_normal((8, D)).astype(np.float32)
    loss_j, recon_j, perp_j = jm.apply({"params": p}, jnp.asarray(x), train=False)

    tm = ConvolutionalVQVAE(12, 16, D, 2, 8, 0.25, 8, encoder_average_pooling=pooling)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        loss, recon, perp = tm(torch.from_numpy(x), train=False)
    assert recon.shape == ((3, 12, 1) if pooling else (3, 12, 20))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(perp.item(), float(perp_j), rtol=RTOL)
