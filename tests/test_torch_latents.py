"""The port's latent analysis, reference-checkpoint import and ``bench_gpu.py``
on the CPU, against the JAX package.

* ``eval.collect_encodings`` against JAX's on the same composite (weights
  carried across by ``composite_params_from_jax``, each codebook made of
  pre-VQ latent rows, so no row sits on a near tie): the encodings exactly;
  ``linear_angle_probe`` within 1e-10; the t-SNE embedding of the same
  encodings within 1e-6 (scikit-learn, seeded); the ``echoe_transfer`` CLI on
  a store;
* reference checkpoints: JAX weights go through JAX's ``eval/torch_export.py``
  into state dicts in the reference's format, and from there through the
  port's ``eval.torch_import`` into port modules whose forward equals JAX's
  within 1e-5: tied and untied stacks, a ``torch.save`` path, the composite
  and the location head; a whole-module pickle of the reference's own class
  where the reference is mounted (as tests/test_reference_parity.py);
* ``bench_gpu.py --device cpu`` at width 1/32 prints one JSON line with its
  keys.

Widths are cut by ``width_scale = 1/32`` and the geometry to 33 bins x 64
frames; JAX's weights are seeded draws of the shapes its models' ``init``
gives (traced, not compiled)."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_tpu.eval import latents as jlatents
from acoustic_locating_vq_vae_tpu.eval.torch_export import echoed_state_dict, location_state_dict, vqvae_state_dict
from acoustic_locating_vq_vae_tpu.models import ConvolutionalVQVAE as JaxVQVAE
from acoustic_locating_vq_vae_tpu.models import LocationModule as JaxLocationModule
from acoustic_locating_vq_vae_torch.cli import echoe_transfer
from acoustic_locating_vq_vae_torch.cli.run_pipeline import smoke_config
from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.eval import (
    build_echoed,
    build_location,
    build_vqvae,
    collect_encodings,
    composite_params_from_jax,
    linear_angle_probe,
    load_reference_state,
    tsne_rir_embedding,
    vqvae_params,
)
from acoustic_locating_vq_vae_torch.eval.torch_import import stack_layout, torch_state_dict
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, LocationTask, SpeechVQVAETask, checkpoint_metadata
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_reference_parity import REFERENCE  # where the reference snapshot is mounted, when it is

WS = 1 / 32
GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames
FWD_TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]

# small VQ-VAEs of both orientations (tests/test_reference_parity.py's configurations)
SPEECH_CFG = dict(in_channels=5, num_hiddens=8, embedding_dim=4, num_residual_layers=3, num_residual_hiddens=6,
                  commitment_cost=0.25, num_embeddings=16)
RIR_CFG = dict(in_channels=10, num_hiddens=8, embedding_dim=4, num_residual_layers=2, num_residual_hiddens=6,
               commitment_cost=0.25, num_embeddings=16, use_jitter=False, out_channels=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_tree(model, *inputs, seed=0):
    """Seeded weights of the shapes ``model.init`` gives: U(+-1/sqrt(fan_in))."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else int(s.shape[0])
        return rng.uniform(-1, 1, s.shape).astype(np.float32) / np.float32(np.sqrt(max(fan_in, 1)))

    return jax.tree_util.tree_map(draw, shapes)


def _spec(b, seed):
    return np.random.default_rng(seed).exponential(1.0, (b, F, T)).astype(np.float32)


def _batches(b, seed):
    """The same rows as a JAX and a port SampleBatch."""
    rng = np.random.default_rng(seed)
    d = dict(speech_spec=_spec(b, seed), rir_spec=_spec(b, seed + 1), echoed_spec=_spec(b, seed + 2),
             fs=np.full((b,), 16000, np.int32), theta=rng.uniform(-3, 3, b).astype(np.float32),
             wiener_est=rng.exponential(1.0, (b, F)).astype(np.float32), radius=np.ones(b, np.float32))
    return (JaxSampleBatch(**{k: jnp.asarray(v) for k, v in d.items()}),
            SampleBatch(**{k: torch.from_numpy(v) for k, v in d.items()}))


def _latent_rows(branch, x, seed):
    """K pre-VQ latent rows of ``x`` as the branch's quantizer sees them."""
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


_COMPOSITES = {}


def _composite(flatten: bool):
    """A JAX composite grafted from speech and RIR VQ-VAEs (their decoders
    included, as the pipeline's is), its codebooks made of latent rows:
    (flax tree, the port's state dict of it)."""
    if flatten not in _COMPOSITES:
        kw = dict(config=JSMALL, width_scale=WS, compat_vq_flatten=flatten)
        xe, xr = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
        speech = _random_tree(jtrain.SpeechVQVAETask(**kw).build_model(), xe, seed=1)["params"]
        rir = _random_tree(jtrain.RirVQVAETask(**kw).build_model(), xr, seed=2)["params"]
        fresh = _random_tree(jtrain.EchoedSpeechTask(**kw).build_model(), xe, xr, seed=3)["params"]
        p = _np(jtrain.graft_pretrained(fresh, speech, rir))
        task = EchoedSpeechTask(config=SMALL, width_scale=WS, compat_vq_flatten=flatten)
        model = task.build_model()
        model.load_state_dict(composite_params_from_jax(p))
        xs, xr_t = task.model_inputs(_batches(2, 10)[1])
        p["speech_model"]["_vq"]["codebook"] = _latent_rows(model.speech_model, xs, 11)
        p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, xr_t, 12)
        _COMPOSITES[flatten] = (p, composite_params_from_jax(p))
    return _COMPOSITES[flatten]


def _tasks(flatten: bool):
    kw = dict(width_scale=WS, compat_vq_flatten=flatten)
    return jtrain.LocationTask(config=JSMALL, **kw), LocationTask(config=SMALL, **kw)


# ---------------------------------------------------------------- latents


@pytest.mark.parametrize("flatten", [True, False], ids=["compat", "vectors"])
def test_collect_encodings_matches_jax(flatten):
    """Both branches' flattened one-hot encodings, exactly, in chunks that
    do not divide the rows; theta as given."""
    p, sd = _composite(flatten)
    jtask, task = _tasks(flatten)
    jb, tb = _batches(7, 20)
    want = jlatents.collect_encodings(jtask, jax.tree_util.tree_map(jnp.asarray, p), jb, batch_size=3)
    got = collect_encodings(task, sd, tb, batch_size=3, device="cpu")
    assert set(got) == set(want) == {"rir_encodings", "speech_encodings", "theta"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rir_encodings"].shape == (7, F * _tasks(flatten)[1].feature_width)
    assert np.all(got["rir_encodings"].reshape(7, F, -1).sum(-1) == 1.0)


def test_linear_angle_probe_matches_jax():
    """The float64 ridge probe in dual form, within 1e-10, and its guard."""
    rng = np.random.default_rng(30)
    feats = rng.standard_normal((20, 5, 7)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, 20)
    feats[:, 0, 0] += np.sin(theta)  # some linearly decodable angle
    got = linear_angle_probe(feats[:15], theta[:15], feats[15:], theta[15:], ridge_lambda=3.0)
    want = jlatents.linear_angle_probe(feats[:15], theta[:15], feats[15:], theta[15:], ridge_lambda=3.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-10, err_msg=k)
    with pytest.raises(ValueError, match=">=2"):
        linear_angle_probe(feats[:1], theta[:1], feats[15:], theta[15:])


def test_tsne_matches_jax_and_names_scikit_learn(monkeypatch):
    """The t-SNE of the same encodings with the same seed: JAX's embedding
    within 1e-6. Without scikit-learn, an ImportError that names it."""
    pytest.importorskip("sklearn.manifold")
    from threadpoolctl import threadpool_limits

    p, sd = _composite(True)
    jtask, task = _tasks(True)
    jb, tb = _batches(10, 21)
    with threadpool_limits(1):  # OpenMP threads of a 10-point t-SNE only spin against the other test workers
        emb, theta = tsne_rir_embedding(task, sd, tb, perplexity=3.0, seed=4, device="cpu")
        jemb, jtheta = jlatents.tsne_rir_embedding(jtask, jax.tree_util.tree_map(jnp.asarray, p), jb,
                                                   perplexity=3.0, seed=4)
    assert emb.shape == (10, 2)
    np.testing.assert_array_equal(theta, jtheta)
    np.testing.assert_allclose(emb, jemb, rtol=1e-6, atol=1e-6)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tsne_rir_embedding(task, sd, tb, device="cpu")


def test_echoe_transfer_cli(tmp_path, capsys):
    """The CLI on a store's composite (the memory-order flatten from its
    metadata), on sets synthesized from --seed: the .npz of the embedding
    and the angles, the probe's two numbers, and a plot."""
    pytest.importorskip("sklearn.manifold")
    from threadpoolctl import threadpool_limits

    cfg = smoke_config()
    task = EchoedSpeechTask(config=cfg, width_scale=1 / 16)
    store = StageStore(str(tmp_path / "store"))
    store.save_stage("finetune", {"model": task.build_model(torch.Generator().manual_seed(0)).state_dict()},
                     metadata=checkpoint_metadata(task, True))
    out = tmp_path / "tsne.npz"
    with threadpool_limits(1):
        res = echoe_transfer.main(["--smoke", "--device", "cpu", "--width-scale", "0.0625", "--store-dir",
                                   str(tmp_path / "store"), "--dataset-size", "4", "--val-size", "12", "--out",
                                   str(out), "--probe"])
    saved = np.load(out)
    assert saved["embedding"].shape == (12, 2) and saved["theta"].shape == (12,)
    assert res["stage"] == "finetune" and set(res["probe"]) == {"r2", "angle_rmse_radians"}
    assert np.isfinite(list(res["probe"].values())).all()
    printed = capsys.readouterr().out
    assert "linear angle probe (finetune, 9/3 train/test)" in printed
    assert (tmp_path / "tsne.png").exists() or "(no plot" in printed


# ---------------------------------------------------------------- reference checkpoints


def _jax_vqvae(cfg, tied=True, seed=0):
    model = JaxVQVAE(**cfg, tied=tied)
    p = _np(_random_tree(model, jnp.zeros((1, cfg["in_channels"], 5)), seed=seed)["params"])
    return model, p


def _vqvae_forward_matches(cfg, model, p, port, length=19):
    x = np.random.default_rng(3).standard_normal((2, cfg["in_channels"], length)).astype(np.float32)
    loss, recon, perp = model.apply({"params": p}, jnp.asarray(x), train=False)
    with torch.no_grad():
        tloss, trecon, tperp = port(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(trecon.numpy(), np.asarray(recon), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=FWD_TOL)
    np.testing.assert_allclose(float(tperp), float(perp), rtol=FWD_TOL)


@pytest.mark.parametrize("cfg", [SPEECH_CFG, RIR_CFG], ids=["speech", "rir"])
def test_tied_vqvae_checkpoint_imports(cfg, tmp_path):
    """A tied reference state dict: the module built from its shapes equals
    JAX's forward, from the dict and from a torch.save path; the port's own
    build of those shapes takes it strictly."""
    model, p = _jax_vqvae(cfg)
    sd = vqvae_state_dict(p, cfg["num_residual_layers"])
    assert stack_layout(torch_state_dict(sd), "_encoder._residual_stack") == (cfg["num_residual_layers"], True)
    port = build_vqvae(sd)
    assert port._encoder._residual_stack._layers[0] is port._encoder._residual_stack._layers[-1]
    _vqvae_forward_matches(cfg, model, p, port)
    path = tmp_path / "ref.pt"
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
    _vqvae_forward_matches(cfg, model, p, build_vqvae(str(path)))
    from acoustic_locating_vq_vae_torch.models import ConvolutionalVQVAE

    same = ConvolutionalVQVAE(**cfg)
    load_reference_state(same, vqvae_params(str(path)))
    _vqvae_forward_matches(cfg, model, p, same)


def test_untied_vqvae_checkpoint_imports_untied():
    """An untied state dict (N different layers) builds an untied module
    that equals JAX's untied forward; loading it into a tied module, which
    would keep only the last layer, raises."""
    model, p = _jax_vqvae(SPEECH_CFG, tied=False, seed=5)
    sd = vqvae_state_dict(p, SPEECH_CFG["num_residual_layers"])
    assert stack_layout(torch_state_dict(sd), "_encoder._residual_stack") == (3, False)
    port = build_vqvae(sd)
    layers = port._encoder._residual_stack._layers
    assert layers[0] is not layers[1]
    _vqvae_forward_matches(SPEECH_CFG, model, p, port)
    from acoustic_locating_vq_vae_torch.models import ConvolutionalVQVAE

    with pytest.raises(ValueError, match="differ"):
        load_reference_state(ConvolutionalVQVAE(**SPEECH_CFG), vqvae_params(sd))


@pytest.mark.parametrize("flatten", [True, False], ids=["compat", "vectors"])
def test_composite_checkpoint_imports(flatten):
    """The reference composite's state dict (both branches and the decoder)
    builds the composite whose forward equals JAX's."""
    p, _ = _composite(flatten)
    jm = jtrain.EchoedSpeechTask(config=JSMALL, width_scale=WS, compat_vq_flatten=flatten).build_model()
    sd = echoed_state_dict(p, 2, 3, 2)
    port = build_echoed(sd, compat_vq_flatten=flatten).eval()
    x = torch.from_numpy(_spec(3, 40))
    x = (x - x.mean(1, keepdim=True)) / x.std(1, keepdim=True)
    want = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, p)}, jnp.asarray(x.numpy()),
                    jnp.asarray(x.transpose(1, 2).numpy()), train=False)
    with torch.no_grad():
        got = port(x, x.transpose(1, 2).contiguous(), train=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=FWD_TOL, atol=FWD_TOL)
    for i in (1, 2):
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=FWD_TOL)


def test_location_head_checkpoint_imports():
    """The reference MLP's state dict builds the head of its widths, equal to
    JAX's forward."""
    jm = JaxLocationModule(encoder_output_dim=F, num_hiddens=4, output_dim=2)
    p = _np(_random_tree(jm, jnp.zeros((1, F, 4)), seed=7)["params"])
    port = build_location(location_state_dict(p))
    x = np.random.default_rng(8).standard_normal((5, F, 4)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": p}, jnp.asarray(x))), rtol=FWD_TOL, atol=FWD_TOL)
    assert got.shape == (5, 2)


@pytest.mark.skipif(not os.path.isdir(os.path.join(REFERENCE, "src")), reason="reference snapshot not mounted")
def test_whole_module_pickle_imports(tmp_path):
    """A torch.save of the reference's own module loads (its package
    importable) and builds a port module with its forward."""
    sys.path.insert(0, os.path.join(REFERENCE, "src"))
    sys.path.insert(0, REFERENCE)
    from acoustic_locating_vq_vae.vq_vae.convolutional_vq_vae import ConvolutionalVQVAE as RefVQVAE

    torch.manual_seed(0)
    ref = RefVQVAE(**SPEECH_CFG).eval()
    path = tmp_path / "module.pt"
    torch.save(ref, path)
    port = build_vqvae(str(path)).eval()
    x = torch.randn(2, SPEECH_CFG["in_channels"], 19)
    with torch.no_grad():
        want, got = ref(x), port(x, train=False)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=FWD_TOL, atol=FWD_TOL)


# ---------------------------------------------------------------- bench_gpu.py


def test_bench_gpu_prints_one_json_line(capsys):
    """--device cpu at width 1/32: one JSON line with bench.py's keys, the
    card, and the secondary fields."""
    spec = importlib.util.spec_from_file_location("bench_gpu", REPO / "bench_gpu.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out = bench.main(["--device", "cpu", "--width-scale", str(WS), "--batch", "4", "--rows", "8", "--steps", "1",
                      "--windows", "1"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == out
    for k in ("metric", "value", "unit", "vs_baseline", "card", "fp32_peak_share", "uncached_frames_per_sec",
              "bf16_cached_frames_per_sec"):
        assert k in out, k
    assert out["unit"] == "frames/s" and out["card"] == "cpu" and out["value"] > 0
    np.testing.assert_allclose(out["vs_baseline"], out["value"] / bench.REFERENCE_CPU_FRAMES_PER_SEC, rtol=1e-2)
    assert "V5E" not in Path(REPO / "bench_gpu.py").read_text()
