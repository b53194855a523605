"""The port's ``eval.torch_export`` against the JAX package's
``eval/torch_export.py`` on the CPU.

The same seeded flax trees go through JAX's export, and through the port's
``eval.params_from_jax`` / ``composite_params_from_jax`` then the port's
export: equal key sets and bitwise equal tensors, for ``vqvae_state_dict``
(gradient and EMA codebook, tied and untied stacks), ``decoder_state_dict``,
``echoed_state_dict`` and ``location_state_dict``. The port's exports are
contiguous CPU clones. A ``save_reference_state_dicts`` bundle, reloaded
with ``torch.load`` and rebuilt through the port's ``eval.torch_import``,
gives bitwise the original modules' forward. (``tests/test_torch_export.py``
is the JAX package's own test of its export.)

Widths are cut to the JAX package's small test configurations and the
composite to ``width_scale = 1/32`` on a 33-bin, 64-frame geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.eval import torch_export as jexport
from acoustic_locating_vq_vae_tpu.models import ConvolutionalVQVAE as JaxVQVAE
from acoustic_locating_vq_vae_tpu.models import LocationModule as JaxLocationModule
from acoustic_locating_vq_vae_torch.data import DatasetConfig
from acoustic_locating_vq_vae_torch.eval import (
    build_echoed,
    build_location,
    build_vqvae,
    composite_params_from_jax,
    decoder_state_dict,
    echoed_state_dict,
    location_state_dict,
    params_from_jax,
    save_reference_state_dicts,
    vqvae_state_dict,
)
from acoustic_locating_vq_vae_torch.models import ConvolutionalVQVAE, LocationModule
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask

WS = 1 / 32
GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames
SPEECH_CFG = dict(in_channels=5, num_hiddens=8, embedding_dim=4, num_residual_layers=3, num_residual_hiddens=6,
                  commitment_cost=0.25, num_embeddings=16)
RIR_CFG = dict(in_channels=10, num_hiddens=8, embedding_dim=4, num_residual_layers=2, num_residual_hiddens=6,
               commitment_cost=0.25, num_embeddings=16, use_jitter=False, out_channels=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _random_tree(model, *inputs, seed=0):
    """Seeded values of every collection ``model.init`` gives (params, and an
    EMA model's vq_stats): U(+-1/sqrt(fan_in)), numpy float32."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else int(s.shape[0])
        return rng.uniform(-1, 1, s.shape).astype(np.float32) / np.float32(np.sqrt(max(fan_in, 1)))

    return jax.tree_util.tree_map(draw, shapes)


def _assert_same(port: dict, want: dict) -> None:
    """Equal key sets; every port tensor a contiguous CPU tensor bitwise
    equal to JAX's array."""
    assert set(port) == set(want), (set(port) ^ set(want))
    for k, v in port.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu" and v.is_contiguous(), k
        assert v.shape == want[k].shape and np.array_equal(v.numpy(), want[k]), k


def _vqvae(cfg, tied=True, ema=False, seed=0):
    """A JAX VQ-VAE's seeded tree and the port's module holding it."""
    tree = _random_tree(JaxVQVAE(**cfg, tied=tied, vq_ema=ema), jnp.zeros((1, cfg["in_channels"], 5)), seed=seed)
    n = cfg["num_residual_layers"]
    port = ConvolutionalVQVAE(**cfg, tied=tied, vq_ema=ema)
    port.load_state_dict(params_from_jax(tree["params"], n, vq_stats=tree.get("vq_stats")))
    return tree, port.eval()


@pytest.mark.parametrize("cfg,tied,ema", [(SPEECH_CFG, True, False), (SPEECH_CFG, False, False),
                                          (SPEECH_CFG, True, True), (RIR_CFG, True, False), (RIR_CFG, True, True)],
                         ids=["speech", "speech-untied", "speech-ema", "rir", "rir-ema"])
def test_vqvae_state_dict_matches_jax(cfg, tied, ema):
    """From the module and from its state dict; the EMA model's codebook is
    the reference's ``_vq._embedding.weight`` and its counts and sums are
    dropped."""
    tree, port = _vqvae(cfg, tied=tied, ema=ema, seed=3)
    want = jexport.vqvae_state_dict(tree["params"], cfg["num_residual_layers"], vq_stats=tree.get("vq_stats"))
    _assert_same(vqvae_state_dict(port), want)
    _assert_same(vqvae_state_dict(port.state_dict()), want)
    if ema:
        assert "_vq.ema_counts" in port.state_dict() and "_vq.ema_sums" in port.state_dict()
        assert np.array_equal(want["_vq._embedding.weight"], tree["vq_stats"]["_vq"]["codebook"])


def test_the_export_is_a_clone():
    _, port = _vqvae(SPEECH_CFG)
    sd = vqvae_state_dict(port)
    before = sd["_encoder._conv_1.weight"].clone()
    with torch.no_grad():
        port._encoder._conv_1.weight.add_(1.0)
    assert torch.equal(sd["_encoder._conv_1.weight"], before)
    live = {t.data_ptr() for t in port.state_dict().values()}
    assert not live & {t.data_ptr() for t in sd.values()}


def test_decoder_state_dict_matches_jax():
    tree, port = _vqvae(SPEECH_CFG, seed=4)
    want = jexport.decoder_state_dict(tree["params"]["_decoder"], SPEECH_CFG["num_residual_layers"])
    _assert_same(decoder_state_dict(port._decoder), want)
    want = jexport.decoder_state_dict(tree["params"]["_decoder"], 3, prefix="dec")
    _assert_same(decoder_state_dict(port._decoder.state_dict(), prefix="dec"), want)


_COMPOSITE = {}


def _composite():
    """A JAX composite grafted from speech and RIR VQ-VAEs (their decoders
    included, as the pipeline's is): (flax params, the port's module)."""
    if not _COMPOSITE:
        kw = dict(config=JSMALL, width_scale=WS)
        xe, xr = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
        speech = _random_tree(jtrain.SpeechVQVAETask(**kw).build_model(), xe, seed=1)["params"]
        rir = _random_tree(jtrain.RirVQVAETask(**kw).build_model(), xr, seed=2)["params"]
        fresh = _random_tree(jtrain.EchoedSpeechTask(**kw).build_model(), xe, xr, seed=3)["params"]
        p = jax.tree_util.tree_map(np.asarray, jtrain.graft_pretrained(fresh, speech, rir))
        model = EchoedSpeechTask(config=SMALL, width_scale=WS).build_model()
        model.load_state_dict(composite_params_from_jax(p))
        _COMPOSITE.update(params=p, model=model.eval())
    return _COMPOSITE["params"], _COMPOSITE["model"]


def test_echoed_state_dict_matches_jax():
    p, model = _composite()
    want = jexport.echoed_state_dict(p, 2, 3, 2)
    _assert_same(echoed_state_dict(model), want)
    _assert_same(echoed_state_dict(model.state_dict()), want)


def _location(seed=7):
    jm = JaxLocationModule(encoder_output_dim=F, num_hiddens=4, output_dim=2)
    p = _random_tree(jm, jnp.zeros((1, F, 4)), seed=seed)["params"]
    port = LocationModule(F, 4, 2)
    port.load_state_dict(params_from_jax(p))
    return p, port.eval()


def test_location_state_dict_matches_jax():
    p, port = _location()
    want = jexport.location_state_dict(p)
    _assert_same(location_state_dict(port), want)
    _assert_same(location_state_dict(port.state_dict()), want)


def test_bundle_reloads_bitwise(tmp_path):
    """The speech VQ-VAE with an EMA codebook, the composite and the location
    head through ``save_reference_state_dicts`` and ``torch.load``, rebuilt by
    ``build_vqvae`` / ``build_echoed`` / ``build_location``: each forward
    bitwise the original's (the rebuilt VQ-VAE holds the codebook as the
    reference's parameter, so its codes, reconstruction and perplexity are
    compared; an EMA quantizer's loss has no codebook term)."""
    _, speech = _vqvae(SPEECH_CFG, ema=True, seed=9)
    _, composite = _composite()
    _, head = _location(seed=10)
    path = tmp_path / "reference.pt"
    save_reference_state_dicts(str(path), {"speech": vqvae_state_dict(speech), "echoed": echoed_state_dict(composite),
                                           "location": location_state_dict(head)})
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    assert set(bundle) == {"speech", "echoed", "location"}

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, SPEECH_CFG["in_channels"], 19)).astype(np.float32))
    rebuilt = build_vqvae(bundle["speech"]).eval()
    with torch.no_grad():
        (_, recon, perp), (_, want_recon, want_perp) = rebuilt(x, train=False), speech(x, train=False)
        codes, want_codes = rebuilt.get_latent_codes(x), speech.get_latent_codes(x)
    assert torch.equal(recon, want_recon) and torch.equal(perp, want_perp) and torch.equal(codes, want_codes)

    xe = torch.from_numpy(rng.standard_normal((3, F, T)).astype(np.float32))
    xr = xe.transpose(1, 2).contiguous()
    with torch.no_grad():
        got, want = build_echoed(bundle["echoed"]).eval()(xe, xr, train=False), composite(xe, xr, train=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    xl = torch.from_numpy(rng.standard_normal((5, F, 4)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(build_location(bundle["location"]).eval()(xl), head(xl))
