"""The port's serving path, whole, against the JAX package's
``eval.serving.make_serving_fn`` on the same weights (carried across by
``params_from_jax``) and the same ``(4, 201, 500)`` input, at width 1/16 on the
CPU; the dsp helpers; the device rule; and the port's independence from JAX."""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import dsp as jdsp
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.eval import make_serving_fn as jax_make_serving_fn
from acoustic_locating_vq_vae_tpu.train import JointLocationTask as JaxJointLocationTask
from acoustic_locating_vq_vae_tpu.train import LocationTask as JaxLocationTask
from acoustic_locating_vq_vae_torch import dsp
from acoustic_locating_vq_vae_torch.data import DatasetConfig
from acoustic_locating_vq_vae_torch.eval import full_fp32, make_serving_fn, params_from_jax
from acoustic_locating_vq_vae_torch.train import JointLocationTask, LocationTask

WS = 1 / 16  # narrows the conv widths only: the 201 x 500 geometry stays
ATOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spec(b, seed):
    """An echoed power spectrogram: non-negative, heavy-tailed."""
    rng = np.random.default_rng(seed)
    return rng.exponential(1.0, (b, 201, 500)).astype(np.float32)


def _latent_codebook(rir, spec, seed):
    """K pre-VQ latent rows of ``spec``, as the quantizer sees them: an
    untrained U(+-1/K) codebook would make the argmin a near-tie lottery."""
    with torch.no_grad():
        x = dsp.znorm(torch.from_numpy(spec), dim=1).transpose(1, 2)
        z = rir.pre_vq_latent(x)
        rows = (z if rir.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, rir.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], rir.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _assert_outputs_close(got, want):
    for g, w, name in zip(got, want, ("theta", "radius", "coords")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize(
    "target_mode,predict_radius", [("sincos", True), ("normalized_angle", False)],
    ids=["sincos_radius", "angle"],
)
def test_joint_serving_matches_jax(target_mode, predict_radius):
    """The deployed configuration (sincos + radius, vectors flatten) and the
    theta/pi head without a range output."""
    kw = dict(width_scale=WS, target_mode=target_mode, predict_radius=predict_radius)
    jtask = JaxJointLocationTask(**kw)
    x_trans = jnp.zeros((1, 500, 201), jnp.float32)
    p = _np(jtask.build_model().init(jax.random.PRNGKey(0), x_trans)["params"])

    task = JointLocationTask(**kw)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    p["rir_model"]["_vq"]["codebook"] = _latent_codebook(model.rir_model, _spec(2, 1), 2)

    spec = _spec(4, 3)
    serve_j, predicts_radius = jax_make_serving_fn(jtask, p, None, True, JaxDatasetConfig())
    assert predicts_radius == predict_radius
    want = jax.jit(serve_j)(jnp.asarray(spec))
    serve = make_serving_fn(task, params_from_jax(p), DatasetConfig(), device="cpu")
    got = serve(spec)
    assert got[0].shape == (4,) and got[1].shape == (4,) and got[2].shape == (4, 3)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize(
    "input_mode,target_mode", [("encodings", "normalized_angle"), ("quantized", "sincos")]
)
def test_frozen_serving_matches_jax(input_mode, target_mode):
    """The frozen localizer: one-hot RIR encodings (the reference input) or
    the quantized latent of the composite's branch (memory-order flatten) into
    the head; the radius is the config's R."""
    kw = dict(width_scale=WS, input_mode=input_mode, target_mode=target_mode)
    jtask = JaxLocationTask(**kw)
    rir_j = jtask.build_composite().rir_model
    rir_p = _np(rir_j.init(jax.random.PRNGKey(1), jnp.zeros((1, 500, 201), jnp.float32))["params"])
    width = 64 if input_mode == "encodings" else 4  # K or D of the branch
    feats = jnp.zeros((1, 201, width), jnp.float32)
    head_p = _np(jtask.build_model().init(jax.random.PRNGKey(2), feats)["params"])

    task = LocationTask(**kw)
    rir = task.build_rir_model()
    assert rir.compat_vq_flatten
    rir.load_state_dict(params_from_jax({"rir_model": rir_p}))
    rir_p["_vq"]["codebook"] = _latent_codebook(rir, _spec(2, 4), 5)
    composite_p = {"rir_model": rir_p}  # the only subtree the frozen path reads

    spec = _spec(4, 6)
    serve_j, _ = jax_make_serving_fn(jtask, head_p, composite_p, False, JaxDatasetConfig())
    want = jax.jit(serve_j)(jnp.asarray(spec))
    serve = make_serving_fn(
        task, params_from_jax(head_p), DatasetConfig(), params_from_jax(composite_p), device="cpu"
    )
    got = serve(spec)
    _assert_outputs_close(got, want)
    np.testing.assert_array_equal(got[1].numpy(), np.full(4, DatasetConfig().R, np.float32))


def test_znorm_and_source_coordinates_match_jax():
    x = _spec(3, 7)
    np.testing.assert_allclose(
        dsp.znorm(torch.from_numpy(x), dim=1).numpy(), np.asarray(jdsp.znorm(jnp.asarray(x), axis=1)),
        rtol=1e-5, atol=1e-6,
    )
    cfg = DatasetConfig()
    theta = np.linspace(-math.pi, math.pi, 17).astype(np.float32)
    radius = np.linspace(0.5, 3.0, 17).astype(np.float32)  # far sources hit the walls
    got = dsp.source_coordinates(
        torch.from_numpy(theta), cfg.receiver_position, cfg.room_dimensions, torch.from_numpy(radius),
        cfg.Z_LOC_SOURCE,
    )
    want = jdsp.source_coordinates(
        jnp.asarray(theta), jnp.asarray(cfg.receiver_position), jnp.asarray(cfg.room_dimensions),
        jnp.asarray(radius), cfg.Z_LOC_SOURCE,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = JointLocationTask(width_scale=WS)
    params = task.build_model(torch.Generator().manual_seed(0)).state_dict()
    with pytest.raises(RuntimeError, match="cuda"):
        make_serving_fn(task, params, DatasetConfig())
    with pytest.raises(ValueError, match="composite_params"):
        make_serving_fn(LocationTask(width_scale=WS), {}, DatasetConfig(), device="cpu")


def test_full_fp32_restores_the_tf32_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    with full_fp32():
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
    assert (cudnn.allow_tf32, matmul.allow_tf32) == before


def _imports(path):
    """Top-level module names a source file imports, by import statement or
    by importlib / __import__ with a literal name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_port_imports_no_jax():
    """Neither the port's package (parallel/, eval/latents.py,
    eval/torch_import.py, cli/echoe_transfer.py, its own copies of data/flac.py
    and data/collate.py, the stage CLIs, native/, eval/torch_export.py,
    utils/viz.py and the tool CLIs among it) nor chip_smoke.py nor
    bench_gpu.py imports jax, flax, the JAX package or bench.py, by any
    import form."""
    sources = sorted((REPO / "src" / "acoustic_locating_vq_vae_torch").rglob("*.py"))
    sources += [REPO / "chip_smoke.py", REPO / "bench_gpu.py"]
    assert len(sources) > 10
    names = {p.relative_to(REPO).as_posix() for p in sources}
    for new in ("parallel/__init__.py", "parallel/mesh.py", "parallel/dp_step.py", "eval/latents.py",
                "eval/torch_import.py", "cli/echoe_transfer.py", "data/flac.py", "data/collate.py",
                "cli/train_speech.py", "cli/train_rir.py", "cli/train_echoed_speech.py",
                "cli/encoder_training_echoed_model.py", "cli/train_location.py", "cli/test_data_set.py",
                "cli/summarize_sweep.py", "native/__init__.py", "native/ism.py", "eval/torch_export.py",
                "utils/viz.py", "cli/impulse_response_demo.py", "cli/make_shifted_corpus.py", "models/encodec.py"):
        assert f"src/acoustic_locating_vq_vae_torch/{new}" in names, new
    banned = {"jax", "jaxlib", "flax", "acoustic_locating_vq_vae_tpu", "bench"}
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert not (_imports(path) & banned), (path, _imports(path) & banned)
