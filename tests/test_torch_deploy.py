"""The port's deploy surface against the JAX package: the exported localizer
artifact (``eval.export_localizer`` / ``load_localizer``) after a save and a
cold load, against JAX's own artifact (``export_localizer(platforms=
("cpu",))``, as tests/test_serving_export.py runs it) and JAX's
``from_audio`` closure, on the same weights (carried across by
``params_from_jax``) and inputs, at width 1/16 and the 201 x 500 geometry on
the CPU; the registered VQ operator in the graph; the precision the loaded
call sets; the sidecar, the provenance and the fingerprint; and the
tracking and resynthesis helpers on the same numpy inputs. Tolerance 1e-4
unless stated. One JAX export and one port export per model, shared by the
module."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data import observed_power_spec as jax_observed_power_spec
from acoustic_locating_vq_vae_tpu.eval import export_localizer as jax_export_localizer
from acoustic_locating_vq_vae_tpu.eval import load_localizer as jax_load_localizer
from acoustic_locating_vq_vae_tpu.eval import make_serving_fn as jax_make_serving_fn
from acoustic_locating_vq_vae_tpu.eval import resynth as jresynth
from acoustic_locating_vq_vae_tpu.eval import tracking as jtracking
from acoustic_locating_vq_vae_tpu.eval.serving import params_fingerprint as jax_params_fingerprint
from acoustic_locating_vq_vae_tpu.eval.serving import store_provenance as jax_store_provenance
from acoustic_locating_vq_vae_tpu.train import JointLocationTask as JaxJointLocationTask
from acoustic_locating_vq_vae_tpu.train import LocationTask as JaxLocationTask
from acoustic_locating_vq_vae_tpu.utils import StageStore as JaxStageStore
from acoustic_locating_vq_vae_torch.data import DatasetConfig, observed_power_spec
from acoustic_locating_vq_vae_torch.dsp import znorm
from acoustic_locating_vq_vae_torch.eval import (
    export_localizer,
    load_localizer,
    make_serving_fn,
    params_fingerprint,
    params_from_jax,
    resynth,
    store_provenance,
    tracking,
    update_sidecar,
)
from acoustic_locating_vq_vae_torch.ops import vq
from acoustic_locating_vq_vae_torch.train import JointLocationTask, LocationTask, checkpoint_metadata
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_torch_serving import _latent_codebook, _np, _spec

WS = 1 / 16  # narrows the conv widths only: the 201 x 500 geometry stays
ATOL = 1e-4
OP = "acoustic_locating_vq_vae_torch.vq_nearest.default"
TIE_RTOL = 1e-6  # chip_smoke.py's tie rule (phase 4): rows whose two codes' distances tie to this


def _assert_close(got, want, what):
    for g, w, name in zip(got, want, ("theta", "radius", "coords")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=f"{what} {name}")


def _graph_targets(call):
    return [str(n.target) for n in call.module.graph.nodes if n.op == "call_function"]


def _joint_weights():
    """JAX's joint localizer (sincos + radius) at width 1/16, its codebook K
    pre-VQ latent rows (an untrained U(+-1/K) codebook makes the argmin a
    near-tie lottery)."""
    kw = dict(width_scale=WS, predict_radius=True)
    jtask = JaxJointLocationTask(**kw)
    p = _np(jtask.build_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 500, 201), jnp.float32))["params"])
    task = JointLocationTask(**kw)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    p["rir_model"]["_vq"]["codebook"] = _latent_codebook(model.rir_model, _spec(2, 1), 2)
    return jtask, p, task, params_from_jax(p)


def _frozen_weights():
    """JAX's frozen localizer (quantized latents, theta/pi) at width 1/16:
    its head and the composite's RIR branch, the codebook of latent rows."""
    kw = dict(width_scale=WS, input_mode="quantized")
    jtask = JaxLocationTask(**kw)
    rir_p = _np(jtask.build_composite().rir_model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 500, 201), jnp.float32))["params"])
    head_p = _np(jtask.build_model().init(jax.random.PRNGKey(2), jnp.zeros((1, 201, 4), jnp.float32))["params"])
    task = LocationTask(**kw)
    rir = task.build_rir_model()
    rir.load_state_dict(params_from_jax({"rir_model": rir_p}))
    rir_p["_vq"]["codebook"] = _latent_codebook(rir, _spec(2, 4), 5)
    composite_p = {"rir_model": rir_p}  # the only subtree the frozen path reads
    return jtask, head_p, composite_p, task, params_from_jax(head_p), params_from_jax(composite_p)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each model exported once by each package on the CPU, the port's
    artifact with a symbolic batch, loaded cold from disk."""
    root = tmp_path_factory.mktemp("deploy")
    cfg, jcfg = DatasetConfig(), JaxDatasetConfig()
    jtask, p, task, params = _joint_weights()
    fjtask, head_p, comp_p, ftask, head, branch = _frozen_weights()
    out = {}
    for name, jargs, args in (
        ("joint", (jtask, p, None, True), (task, params, None)),
        ("frozen", (fjtask, head_p, comp_p, False), (ftask, head, branch)),
    ):
        jax_export_localizer(*jargs, jcfg, str(root / f"jax_{name}"), platforms=("cpu",))
        t, prm, comp = args
        meta = export_localizer(t, prm, cfg, str(root / name), composite_params=comp, device="cpu")
        call, meta2 = load_localizer(str(root / name))
        jcall, jmeta = jax_load_localizer(str(root / f"jax_{name}"))
        out[name] = dict(call=call, meta=meta, meta2=meta2, jcall=jcall, jmeta=jmeta, task=t, params=prm, comp=comp,
                         dir=root / name)
    out["joint"]["jax"] = (jtask, p)
    return out


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("name", ["joint", "frozen"])
def test_artifact_after_load_matches_jax(exported, name, b):
    """The symbolic batch serves B = 1, 3 and 8; the loaded artifact agrees
    with JAX's loaded artifact on the same spectrograms."""
    e = exported[name]
    spec = _spec(b, 10 + b)
    got = e["call"](spec)
    assert got[0].shape == (b,) and got[1].shape == (b,) and got[2].shape == (b, 3)
    _assert_close(got, e["jcall"](jnp.asarray(spec)), f"{name} B={b}")


def test_pinned_artifact_serves_its_size_and_rejects_another(exported, tmp_path):
    e = exported["joint"]
    meta = export_localizer(e["task"], e["params"], DatasetConfig(), str(tmp_path), batch_size=3, device="cpu")
    assert meta["input"]["shape"] == [3, 201, 500]
    call, _ = load_localizer(str(tmp_path))
    spec = _spec(3, 20)
    _assert_close(call(spec), e["jcall"](jnp.asarray(spec)), "pinned")
    with pytest.raises((AssertionError, RuntimeError)):
        call(_spec(4, 21))  # as JAX's pinned artifact rejects another size


def test_from_audio_artifact_matches_jax_closure(exported, tmp_path):
    """Raw 80,000-sample waveforms in: the port's artifact (``torch.stft``
    frontend fused in) against JAX's ``from_audio`` closure. The codebook
    is made of latent rows of these waveforms' spectrograms, so the argmin
    is no lottery. A sample may miss only where the two STFTs' float
    rounding flips a code at a near tie: then its codes differ on the two
    packages' spectrograms, and the flipped rows tie under chip_smoke.py's
    rule (phase 4), ``|d(x, e_a) - d(x, e_b)| <= TIE_RTOL (|x|^2 + |e|^2)``."""
    jtask, p = exported["joint"]["jax"]
    task = exported["joint"]["task"]
    cfg = DatasetConfig()
    wave = np.random.default_rng(30).standard_normal((5, cfg.audio_samples)).astype(np.float32)
    spec_t = observed_power_spec(torch.from_numpy(wave), cfg)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    p = jax.tree_util.tree_map(np.copy, p)
    p["rir_model"]["_vq"]["codebook"] = _latent_codebook(model.rir_model, spec_t[3:].numpy(), 31)
    params = params_from_jax(p)
    meta = export_localizer(task, params, cfg, str(tmp_path), device="cpu", from_audio=True)
    assert meta["input"] == {"name": "echoed_waveform", "shape": ["b", cfg.audio_samples], "dtype": "float32"}
    call, _ = load_localizer(str(tmp_path))
    got = call(wave[:3])
    serve_j, _ = jax_make_serving_fn(jtask, p, None, True, JaxDatasetConfig(), from_audio=True)
    want = jax.jit(serve_j)(jnp.asarray(wave[:3]))
    dtheta = np.abs(np.angle(np.exp(1j * (got[0].numpy() - np.asarray(want[0])))))
    miss = np.nonzero(dtheta > ATOL)[0]
    if miss.size:  # each miss must be a near-tie code flip of the STFT's rounding
        model.load_state_dict(params)
        spec_j = torch.from_numpy(np.asarray(jax_observed_power_spec(jnp.asarray(wave[miss]), JaxDatasetConfig())))
        rir = model.rir_model
        with torch.no_grad():
            z = rir.pre_vq_latent(znorm(torch.cat([spec_t[miss], spec_j]), dim=1).transpose(1, 2))
        rows = z.transpose(1, 2).reshape(2, miss.size, -1, rir.embedding_dim).double()
        cb = rir._vq._embedding.weight.double()
        d = ((rows[..., None, :] - cb) ** 2).sum(-1)  # (package, sample, row, code)
        codes = d.argmin(-1)
        flipped = codes[0] != codes[1]
        assert bool(flipped.any(1).all()), "a sample missed without a flipped code"
        gap = (d[0].gather(-1, codes[0][..., None]) - d[0].gather(-1, codes[1][..., None])).abs()[..., 0]
        scale = (rows[0] ** 2).sum(-1) + torch.maximum((cb[codes[0]] ** 2).sum(-1), (cb[codes[1]] ** 2).sum(-1))
        assert bool((gap[flipped] <= TIE_RTOL * scale[flipped]).all())
    keep = np.setdiff1d(np.arange(3), miss)
    assert keep.size >= 2
    _assert_close([t[keep] for t in got], [np.asarray(w)[keep] for w in want], "from_audio")


def test_bf16_task_exports_its_bf16_branch(exported, tmp_path):
    """A ``compute_dtype="bfloat16"`` task's artifact runs its RIR branch in
    bf16, as its live closure does (and as JAX's export does through
    ``task.build_model()``), so the two agree, and differ from FP32."""
    import dataclasses

    e = exported["joint"]
    task = dataclasses.replace(e["task"], compute_dtype="bfloat16")
    export_localizer(task, e["params"], DatasetConfig(), str(tmp_path), device="cpu")
    call, _ = load_localizer(str(tmp_path))
    spec = _spec(3, 60)
    got = call(spec)
    _assert_close(got, make_serving_fn(task, e["params"], DatasetConfig(), device="cpu")(spec), "bf16")
    assert float((got[2] - e["call"](spec)[2]).abs().max()) > 0  # not the FP32 program
    assert _graph_targets(call).count(OP) == 1


@pytest.mark.parametrize("n,d,k", [(50, 4, 16), (402, 4, 64), (7, 130, 3)])
def test_vq_nearest_is_a_registered_op(n, d, k):
    g = torch.Generator().manual_seed(n)
    x, cb = torch.randn(n, d, generator=g), torch.randn(k, d, generator=g)
    torch.library.opcheck(vq.vq_nearest, (x, cb))
    got = torch.ops.acoustic_locating_vq_vae_torch.vq_nearest(x, cb)
    assert got.dtype == torch.int32 and torch.equal(got, vq.nearest_codebook(x, cb)[0].to(torch.int32))


@pytest.mark.parametrize("name", ["joint", "frozen"])
def test_exported_graph_calls_the_op_and_no_argmin(exported, name):
    targets = _graph_targets(exported[name]["call"])
    assert targets.count(OP) == 1
    assert not [t for t in targets if "argmin" in t or "addmm" in t]


def test_loaded_call_turns_tf32_off_and_restores_the_flags(exported):
    """Trap 2: TF32 is Python state, not a graph node, so the loaded call
    sets it: off inside, as before after."""
    call = exported["joint"]["call"]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    inner, seen = call.module.forward, []

    def spy(*a, **kw):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return inner(*a, **kw)

    saved = cudnn.allow_tf32, matmul.allow_tf32
    call.module.forward = spy
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        call(_spec(1, 40))
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        del call.module.forward
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_load_refuses_a_device_the_host_lacks(exported, tmp_path, monkeypatch):
    e = exported["joint"]
    with pytest.raises(ValueError, match="export it again"):
        load_localizer(str(e["dir"]), device="cuda")
    meta = dict(e["meta"], platforms=["cuda"])
    (tmp_path / "serving.json").write_text(json.dumps(meta))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_localizer(str(tmp_path))


def test_sidecar_keys_provenance_and_update(exported, tmp_path):
    """The sidecar has JAX's keys, its provenance round-trips through the
    JSON, and a post-export summary merges into it."""
    e = exported["joint"]
    jtask, p = e["jax"]
    jstore = JaxStageStore(str(tmp_path / "jstore"))
    jstore.save_stage("location_joint", {"params": p}, step=7, metadata={"task": "location_joint"})
    jprov = jax_store_provenance(jstore, "location_joint", p, task=jtask)
    jmeta = jax_export_localizer(jtask, p, None, True, JaxDatasetConfig(), str(tmp_path / "jart"), platforms=("cpu",),
                                 provenance=jprov)

    store = StageStore(str(tmp_path / "store"))
    store.save_stage("location_joint", {"model": e["params"]}, step=7, metadata=checkpoint_metadata(e["task"], True))
    prov = store_provenance(store, "location_joint", e["params"], task=e["task"])
    assert set(prov) == set(jprov) and set(prov["task_modes"]) == set(jprov["task_modes"])
    assert prov["stage_manifest"]["step"] == 7 and prov["task_modes"]["predict_radius"] is True
    assert prov["stage_manifest"]["metadata"]["target_mode"] == "sincos"
    meta = export_localizer(e["task"], e["params"], DatasetConfig(), str(tmp_path / "art"), device="cpu",
                            provenance=prov)
    assert set(meta) == set(jmeta)
    assert set(meta["input"]) == set(jmeta["input"]) and meta["outputs"] == jmeta["outputs"]
    assert meta["geometry"] == jmeta["geometry"] and meta["platforms"] == ["cpu"]
    assert meta["bytes"] == os.path.getsize(tmp_path / "art" / "localizer.pt2")
    _, loaded = load_localizer(str(tmp_path / "art"))
    assert loaded["provenance"] == json.loads(json.dumps(prov))
    merged = update_sidecar(str(tmp_path / "art"), eval_summary={"verified": True})
    _, loaded = load_localizer(str(tmp_path / "art"))
    assert loaded == merged and loaded["eval_summary"] == {"verified": True}
    assert loaded["provenance"]["params_sha256"] == params_fingerprint(e["params"])
    assert len(jax_params_fingerprint(p)) == len(loaded["provenance"]["params_sha256"]) == 64


def test_fingerprint_follows_the_weights_bit_for_bit(exported):
    params = exported["joint"]["params"]
    same = {k: v.clone() for k, v in reversed(list(params.items()))}
    assert params_fingerprint(same) == params_fingerprint(params)
    key = "head.fc_5.bias"
    flipped = dict(params)
    flipped[key] = (params[key].view(torch.int32) ^ 1).view(torch.float32)
    assert params_fingerprint(flipped) != params_fingerprint(params)
    renamed = dict(params)
    renamed["extra"] = renamed.pop(key)
    assert params_fingerprint(renamed) != params_fingerprint(params)


# ---------------------------------------------------------------- tracking and resynthesis


def _bitwise(got, want):
    if isinstance(want, dict):
        assert got == want
    else:
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


_RNG = np.random.default_rng(50)
_THETA = np.cumsum(_RNG.normal(0.0, 0.3, 40)).astype(np.float32) + 2.9
_NOISY = (_THETA + _RNG.normal(0.0, 0.1, 40)).astype(np.float32)
TRACKING_CASES = {
    "wrap_angle": ("wrap_angle", (_THETA,), {}),
    "arc": ("arc_trajectory", (24, -2.8, 3.8, 0.7, 1.3), {}),
    "arc_fixed_radius": ("arc_trajectory", (5, 0.0, 1.0), {}),
    "walk": ("walk_trajectory", (30,), dict(seed=3, radius=0.9, radius_step=0.05)),
    "alpha_beta": ("alpha_beta_filter", (_NOISY,), dict(alpha=0.4, beta=0.05)),
    "track_metrics": ("track_metrics", (_THETA, _NOISY, _NOISY[::-1].copy()),
                      dict(radius_true=np.full(40, 1.0), radius_pred=np.linspace(0.9, 1.1, 40))),
}


@pytest.mark.parametrize("case", list(TRACKING_CASES))
def test_tracking_is_bitwise_jax(case):
    fn, args, kw = TRACKING_CASES[case]
    _bitwise(getattr(tracking, fn)(*args, **kw), getattr(jtracking, fn)(*args, **kw))


def test_spectral_snr_and_write_wav_match_jax(tmp_path):
    """The SNR agrees to float32 rounding of the two packages' sums (1e-5
    relative); the 16-bit files are byte for byte JAX's."""
    rng = np.random.default_rng(51)
    ref = rng.exponential(1.0, (33, 100)).astype(np.float32)
    est = (ref * rng.uniform(0.8, 1.2, ref.shape)).astype(np.float32)
    got = float(resynth.spectral_snr_db(torch.from_numpy(ref), torch.from_numpy(est)))
    want = float(jresynth.spectral_snr_db(jnp.asarray(ref), jnp.asarray(est)))
    assert abs(got - want) <= 1e-5 * abs(want)
    audio = rng.standard_normal(1600).astype(np.float32)
    resynth.write_wav(str(tmp_path / "port.wav"), torch.from_numpy(audio), 16000)
    jresynth.write_wav(str(tmp_path / "jax.wav"), audio, 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_audio_from_power_spec_matches_jax_from_its_initial_phase(monkeypatch):
    """Griffin-Lim from JAX's own initial phase: the port's
    ``audio_from_power_spec`` with its draw replaced by that phase, through
    ``griffin_lim_from_angle``, against JAX's ``audio_from_power_spec``."""
    from acoustic_locating_vq_vae_torch.dsp import griffin_lim_from_angle, spectrogram

    cfg = DatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
    jcfg = JaxDatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
    wave = np.random.default_rng(52).standard_normal((2, 1600)).astype(np.float32)
    power = spectrogram(torch.from_numpy(wave), n_fft=64, hop_length=32, power=2.0)
    key = jax.random.PRNGKey(9)
    angle = torch.from_numpy(np.asarray(jax.random.uniform(key, power.shape, minval=0.0, maxval=2.0 * jnp.pi)))
    monkeypatch.setattr(resynth, "griffin_lim", lambda mag, gen, **kw: griffin_lim_from_angle(mag, angle, **kw))
    got = resynth.audio_from_power_spec(power, torch.Generator(), cfg, n_iter=4, length=1600)
    want = np.asarray(jresynth.audio_from_power_spec(jnp.asarray(power.numpy()), key, jcfg, n_iter=4, length=1600))
    assert got.shape == want.shape == (2, 1600)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
    complex_spec = spectrogram(torch.from_numpy(wave), n_fft=64, hop_length=32, power=None)
    back = resynth.audio_from_complex_spec(complex_spec, cfg, length=1600)
    jback = np.asarray(jresynth.audio_from_complex_spec(jnp.asarray(complex_spec.numpy()), jcfg, length=1600))
    np.testing.assert_allclose(back.numpy(), jback, rtol=0, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), wave, rtol=0, atol=ATOL)
