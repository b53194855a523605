"""The port's deploy and evaluation entry points (``cli.export_localizer``,
``locate``, ``track``, ``eval_t60_sweep``, ``compare_location_models``,
``resynthesize``), each run in process through ``main(argv)`` with
``--smoke --device cpu`` on a stage store the test writes at width 1/16:
the JSON each prints has the keys of the JAX package's script (every key is
also a string of that script or of the JAX module it takes them from), the
exported joint artifact agrees with JAX's serving closure on the same
weights (carried across by ``params_from_jax``; tolerance 1e-4), and
``--device cuda`` without a card raises.

The store: the joint stage holds JAX's weights (sincos + radius, vectors
flatten, its codebook made of latent rows); the frozen location head, the
composite (as ``echoed`` and ``finetune``) and the speech stage hold the
port's seeded initialisation (their parity with JAX is
tests/test_torch_stages.py's). Each stage carries the metadata ``Trainer``
writes (``train.checkpoint_metadata``)."""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.eval import make_serving_fn as jax_make_serving_fn
from acoustic_locating_vq_vae_tpu.train import JointLocationTask as JaxJointLocationTask
from acoustic_locating_vq_vae_torch.cli import (
    compare_location_models,
    eval_t60_sweep,
    export_localizer,
    locate,
    resynthesize,
    track,
)
from acoustic_locating_vq_vae_torch.cli.run_pipeline import smoke_config
from acoustic_locating_vq_vae_torch.eval import load_localizer, params_from_jax
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask,
    JointLocationTask,
    LocationTask,
    SpeechVQVAETask,
    checkpoint_metadata,
)
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_torch_serving import _latent_codebook, _np

WS = 1 / 16
REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)  # the --smoke geometry
# --smoke at width 1/16 on the CPU, with small synthesized sets
COMMON = ["--smoke", "--device", "cpu", "--width-scale", str(WS), "--dataset-size", "8", "--val-size", "4"]


def _spec(b, seed, cfg):
    return np.random.default_rng(seed).exponential(1.0, (b, cfg.num_freq, cfg.num_frames)).astype(np.float32)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """``(store dir, JAX joint task, JAX joint params)``."""
    root = tmp_path_factory.mktemp("deploy_cli")
    cfg = smoke_config()
    g = torch.Generator().manual_seed(0)
    jtask = JaxJointLocationTask(config=JaxDatasetConfig(**SMALL), width_scale=WS, predict_radius=True)
    x = jnp.zeros((1, cfg.num_frames, cfg.num_freq), jnp.float32)
    p = _np(jtask.build_model().init(jax.random.PRNGKey(0), x)["params"])
    joint = JointLocationTask(config=cfg, width_scale=WS, predict_radius=True)
    model = joint.build_model()
    model.load_state_dict(params_from_jax(p))
    p["rir_model"]["_vq"]["codebook"] = _latent_codebook(model.rir_model, _spec(4, 1, cfg), 2)
    kw = dict(config=cfg, width_scale=WS, compat_vq_flatten=False)  # the pipeline's fixed preset
    location = LocationTask(**kw, input_mode="quantized")
    composite = EchoedSpeechTask(**kw).build_model(g).state_dict()
    speech = SpeechVQVAETask(**kw)
    s = StageStore(str(root / "store"))
    for task, tag, weights in (
        (speech, "speech", speech.build_model(g).state_dict()),
        (EchoedSpeechTask(**kw), "echoed", composite),
        (EchoedSpeechTask(**kw), "finetune", composite),
        (location, "location", location.build_model(g).state_dict()),
        (joint, "location_joint", params_from_jax(p)),
    ):
        s.save_stage(tag, {"model": weights, "step": 3}, step=3, metadata=dict(checkpoint_metadata(task, True),
                                                                              task=tag))
    return str(root / "store"), jtask, p


def _run(main, argv, capsys):
    """``main(argv)``'s return and the JSON object it printed last."""
    out = main(argv)
    lines = capsys.readouterr().out.splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return out, json.loads("\n".join(lines[start:]))


def _jax_strings(*paths):
    """Every string constant of the JAX package's sources at ``paths``."""
    out = set()
    for path in paths:
        tree = ast.parse((REPO / path).read_text())
        out |= {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return out


LATENCY_KEYS = {"batch", "iters", "mean_ms", "p50_ms", "min_ms", "samples_per_s"}  # scripts/_common.py:657-664
METRIC_KEYS = {"mse_theta_over_pi", "rmse_theta_over_pi", "rmse_radians", "median_abs_radians", "p90_abs_radians",
               "frac_err_gt_0.1rad", "frac_err_gt_1rad", "rmse_coordinates_m", "num_samples"}


def _check_keys(got: set, want: set, *jax_sources):
    assert got == want
    assert want - {"device"} <= _jax_strings(*jax_sources)


def test_locate_keys_match_jax(store, capsys):
    out, printed = _run(locate.main, COMMON + ["--store-dir", store[0], "--n", "3", "--latency", "2"], capsys)
    assert printed == json.loads(json.dumps(out))
    _check_keys(set(out), {"model", "samples", "rmse_radians", "rmse_radius_m", "latency"}, "scripts/locate.py")
    _check_keys({k for s in out["samples"] for k in s},
                {"theta_pred_rad", "coordinates_m", "theta_true_rad", "abs_error_rad", "radius_pred_m"},
                "scripts/locate.py")
    # the port's bench names the device it ran on beside JAX's keys
    _check_keys(set(out["latency"]), LATENCY_KEYS | {"device"}, "scripts/_common.py")
    assert out["model"] == "joint" and len(out["samples"]) == 3 and out["latency"]["device"] == "cpu"


def test_locate_frozen_has_no_range_keys(store, capsys):
    out, _ = _run(locate.main, COMMON + ["--store-dir", store[0], "--n", "2", "--model", "frozen"], capsys)
    assert out["model"] == "frozen" and set(out) == {"model", "samples", "rmse_radians"}
    assert {k for s in out["samples"] for k in s} == {"theta_pred_rad", "coordinates_m", "theta_true_rad",
                                                      "abs_error_rad"}


def test_track_keys_match_jax_across_the_seam(store, capsys, tmp_path):
    argv = COMMON + ["--store-dir", store[0], "--windows", "6", "--theta-start", "2.8", "--theta-end", "3.8",
                     "--radius-start", "0.8", "--radius-end", "1.1", "--out", str(tmp_path / "t.npz")]
    out, printed = _run(track.main, argv, capsys)
    assert printed == json.loads(json.dumps(out))
    jax_src = ("scripts/track.py", "src/acoustic_locating_vq_vae_tpu/eval/tracking.py")
    _check_keys(set(out), {"model", "trajectory", "windows", "window_seconds", "rmse_radians", "median_abs_radians",
                           "max_abs_radians", "rmse_smoothed_radians", "rmse_radius_m", "track", "saved"}, *jax_src)
    _check_keys({k for w in out["track"] for k in w}, {"theta_true_rad", "theta_pred_rad", "theta_smoothed_rad",
                                                        "radius_true_m", "radius_pred_m"}, *jax_src)
    true = [w["theta_true_rad"] for w in out["track"]]
    assert max(true) <= np.pi and min(true) < 0  # wrapped through the seam
    with np.load(tmp_path / "t.npz") as z:
        assert set(z.files) == {"theta_true", "theta_pred", "theta_smoothed", "radius_true", "radius_pred"}
        np.testing.assert_allclose(z["radius_true"], np.linspace(0.8, 1.1, 6), rtol=1e-6)


def test_track_walk_and_leaving_the_room(store, capsys):
    out, _ = _run(track.main, COMMON + ["--store-dir", store[0], "--windows", "4", "--trajectory", "walk",
                                        "--model", "frozen"], capsys)
    assert out["trajectory"] == "walk" and "rmse_radius_m" not in out and len(out["track"]) == 4
    with pytest.raises(SystemExit, match="leaves the room"):
        track.main(COMMON + ["--store-dir", store[0], "--windows", "3", "--radius-start", "2.0"])


def test_eval_t60_sweep_keys_match_jax(store, capsys):
    argv = COMMON + ["--store-dir", store[0], "--t60-grid", "0.3", "0.5", "--radius-grid", "0.9", "--snr-grid", "20"]
    out, printed = _run(eval_t60_sweep.main, argv, capsys)
    assert printed == out
    _check_keys(set(out), {"model", "t60_grid", "radius_grid", "snr_grid_db", "rmse_radians_min", "rmse_radians_max"},
                "scripts/eval_t60_sweep.py")
    assert out["t60_grid"] == [0.3, 0.5] and out["snr_grid_db"] == [20.0]
    assert np.isfinite([out["rmse_radians_min"], out["rmse_radians_max"]]).all()
    with pytest.raises(SystemExit, match="leave the room"):
        eval_t60_sweep.main(COMMON + ["--store-dir", store[0], "--radius-grid", "3.0"])


def test_compare_location_models_keys_match_jax(store, capsys):
    out, printed = _run(compare_location_models.main, COMMON + ["--store-dir", store[0]], capsys)
    assert printed == out
    assert set(out) == {"echoed", "finetune", "location_joint"}
    for name in ("echoed", "finetune"):
        _check_keys(set(out[name]), METRIC_KEYS, "src/acoustic_locating_vq_vae_tpu/eval/compare.py")
    _check_keys(set(out["location_joint"]), METRIC_KEYS | {"rmse_radius_m", "median_abs_radius_m"},
                "src/acoustic_locating_vq_vae_tpu/eval/compare.py")
    assert out["echoed"] == out["finetune"]  # one composite stored twice


@pytest.mark.parametrize("model", ["joint", "frozen"])
def test_export_cli_writes_a_verified_artifact(store, capsys, tmp_path, model):
    """The CLI's artifact reloads cold, its summary and provenance sit in the
    sidecar, and the joint one agrees with JAX's closure on the same
    weights."""
    art = tmp_path / "art"
    argv = COMMON + ["--store-dir", store[0], "--out-dir", str(art), "--model", model, "--verify-n", "3",
                     "--latency", "2"]
    out, printed = _run(export_localizer.main, argv, capsys)
    assert printed == json.loads(json.dumps(out))
    _check_keys(set(out), {"verified", "max_abs_diff", "theta_pred_rad", "artifact_latency"},
                "scripts/export_localizer.py")
    assert out["verified"] and set(out["max_abs_diff"]) == {"theta_rad", "radius_m", "coords_m"}
    call, meta = load_localizer(str(art))
    assert meta["eval_summary"] == json.loads(json.dumps(out)) and meta["platforms"] == ["cpu"]
    prov = meta["provenance"]
    assert prov["stage"] == ("location_joint" if model == "joint" else "location")
    assert prov["stage_manifest"]["step"] == 3
    if model == "frozen":
        assert prov["composite_stage"] == "finetune" and len(prov["composite_params_sha256"]) == 64
        return
    assert prov["task_modes"] == {"compat_vq_flatten": False, "target_mode": "sincos", "predict_radius": True}
    _, jtask, p = store
    spec = _spec(5, 7, smoke_config())
    serve_j, _ = jax_make_serving_fn(jtask, p, None, True, JaxDatasetConfig(**SMALL))
    for got, want in zip(call(spec), jax.jit(serve_j)(jnp.asarray(spec))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_export_cli_from_audio(store, capsys, tmp_path):
    argv = COMMON + ["--store-dir", store[0], "--out-dir", str(tmp_path), "--from-audio", "--export-batch", "3",
                     "--verify-n", "3"]
    out, _ = _run(export_localizer.main, argv, capsys)
    assert out["verified"]
    _, meta = load_localizer(str(tmp_path))
    assert meta["input"] == {"name": "echoed_waveform", "shape": [3, 3200], "dtype": "float32"}


def test_resynthesize_writes_both_wavs(store, capsys, tmp_path):
    out = resynthesize.main(COMMON + ["--store-dir", store[0], "--out-prefix", str(tmp_path / "r"), "--gl-iters", "4"])
    text = capsys.readouterr().out
    assert "r_original.wav (Griffin-Lim, 4 iters)" in text and "r_recon.wav (model recon, perplexity" in text
    assert (tmp_path / "r_original.wav").stat().st_size > 44 and (tmp_path / "r_recon.wav").stat().st_size > 44
    assert np.isfinite(out["spectral_snr_db"])


CLIS = {"export_localizer": (export_localizer, ["--out-dir", "unused"]), "locate": (locate, []), "track": (track, []),
        "eval_t60_sweep": (eval_t60_sweep, []), "compare_location_models": (compare_location_models, []),
        "resynthesize": (resynthesize, [])}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_on_cuda_without_a_card_raises(store, monkeypatch, name):
    module, extra = CLIS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--smoke", "--width-scale", str(WS), "--store-dir", store[0], *extra])
