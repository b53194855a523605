"""The port's on-device synthesis against the JAX package's, on the same
draws: the source-filter speech (``data/speech.py``), ``synthesize_batch``
with each of its options, ``prune_batch``, ``make_dataset``, the reference's
``.pt`` format, and the two entry points that synthesize
(``cli.generate_dataset`` and ``cli.run_pipeline`` without ``--data-dir``).

Philox cannot replay JAX's threefry streams, so the parity tests replay
JAX's own draws (``jax.random.split`` / ``fold_in`` as ``speech.py:45-86`` and
``synth.py:473-640`` take them) into the port's deterministic bodies; the
port's draw step is checked for what it promises (shapes, ranges, options
that change no other draw). The geometry is the JAX CLIs' smoke geometry
(512-tap RIRs, 0.2 s of audio, a 64-point STFT), except one speech test at
the full 5 s. Float tolerances are stated at each assert, relative to the
largest magnitude. The ``cuda`` test needs a card and skips without one; the
card's machine has no JAX, so the JAX imports are guarded and there this file
runs its ``cuda`` test alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_synth.py -q
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import data as jdata
    from acoustic_locating_vq_vae_tpu.data import speech as jspeech
    from acoustic_locating_vq_vae_tpu.data import synth as jsynth
except ImportError:  # the card's machine: only the cuda test runs there
    jax = jnp = jdata = jspeech = jsynth = None
from acoustic_locating_vq_vae_torch import data
from acoustic_locating_vq_vae_torch.cli import generate_dataset
from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli_pipeline
from acoustic_locating_vq_vae_torch.data import SampleBatch, SynthDraws, speech

GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
SMOKE = data.DatasetConfig(**GEOMETRY)
JSMOKE = jdata.DatasetConfig(**GEOMETRY) if jdata is not None else None
B = 4
FIELDS = SampleBatch._fields
# phase 11 of chip_smoke.py: the card against the port in float64 on the CPU, max |error| / max |float64|
# (rir_spec: after each sample's scale is divided out, ratio_shape_err)
CARD_LIMITS = {"rir": 1e-4, "speech_spec": 1e-6, "echoed_spec": 5e-5, "wiener_est": 3e-4, "rir_spec": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU ops run faster on one thread, alone and beside the
    suite's other workers; the setting comes back after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def jax_fields(b) -> list:
    return [np.array(a) for a in (*b.as_tuple(), b.radius)]


# ---------------------------------------------------------------- speech


def jax_speech_draws(key, batch, n, fs=16000) -> speech.SpeechDraws:
    """The draws of JAX's ``synthetic_speech_batch`` (speech.py:45-86), replayed."""
    k_f0, k_ph, k_noise, k_env, k_voic, k_formant = jax.random.split(key, 6)
    k1, k2 = jax.random.split(k_ph)
    kf1, kf2 = jax.random.split(k_formant)
    n_ctrl = max(2, int(n / fs * 8))
    u = jax.random.uniform
    return speech.SpeechDraws(*(t_(a) for a in (
        u(k_f0, (batch, 1), minval=90.0, maxval=240.0),
        u(k1, (batch, 1), minval=0.5, maxval=3.0),
        u(k2, (batch, 1), maxval=2 * jnp.pi),
        jax.random.normal(k_noise, (batch, n)) * 0.5,
        u(k_env, (batch, n_ctrl), minval=0.05, maxval=1.0),
        u(k_voic, (batch, n_ctrl), minval=0.0, maxval=1.0),
        u(kf1, (batch, 3, 1), minval=300.0, maxval=3400.0),
        u(kf2, (batch, 3, 1), minval=80.0, maxval=300.0),
    )))


@pytest.mark.parametrize("n,atol", [(3200, 1e-3), (80000, 1e-2)])
def test_speech_body_matches_jax_draws(n, atol):
    """The body from JAX's own draws. The phase is a float32 cumulative sum of
    f0 over every sample: XLA-CPU's drifts up to 3.3 units of the sum from
    float64 over 80,000 samples, torch-CPU's (accumulated in double) 0.5, and
    twelve harmonics amplify the phase error, so unit-peak waveforms differ
    by 1.6e-4 at 3,200 samples and 2.2e-3 at 80,000 (limits 1e-3, 1e-2)."""
    key = jax.random.PRNGKey(21)
    want = np.asarray(jspeech.synthetic_speech_batch(key, 3, n, 16000))
    got = speech.speech_from_draws(jax_speech_draws(key, 3, n))
    assert got.shape == (3, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_allclose(np.abs(got.numpy()).max(axis=1), 1.0, rtol=1e-6)


def test_speech_draws_shapes_ranges_and_determinism():
    d = speech.speech_draws(torch.Generator().manual_seed(0), 64, 16000)
    assert d.noise.shape == (64, 16000) and d.energy_ctrl.shape == (64, 8) and d.centers.shape == (64, 3, 1)
    for a, lo, hi in ((d.f0_base, 90, 240), (d.wander_rate, 0.5, 3), (d.wander_phase, 0, 2 * math.pi),
                      (d.energy_ctrl, 0.05, 1), (d.voicing_ctrl, 0, 1), (d.centers, 300, 3400),
                      (d.bandwidths, 80, 300)):
        assert float(a.min()) >= lo and float(a.max()) <= hi and float(a.max() - a.min()) > 0.5 * (hi - lo)
    assert abs(float(d.noise.std()) - 0.5) < 0.01
    a = speech.synthetic_speech_batch(torch.Generator().manual_seed(3), 2, 3200)
    b = speech.synthetic_speech_batch(torch.Generator().manual_seed(3), 2, 3200)
    assert torch.equal(a, b)


def test_load_wav_dir_matches_jax(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(5)
    wavfile.write(tmp_path / "b.wav", 16000, (rng.standard_normal(4000) * 3000).astype(np.int16))
    wavfile.write(tmp_path / "a.wav", 16000, rng.standard_normal((2000, 2)).astype(np.float32))
    (tmp_path / "notes.txt").write_text("not a wav")
    got = data.load_wav_dir(str(tmp_path), 3200)
    np.testing.assert_array_equal(got, jspeech.load_wav_dir(str(tmp_path), 3200))
    assert got.shape == (2, 3200) and got.dtype == np.float32
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        data.load_wav_dir(str(tmp_path / "empty"), 10)


# ---------------------------------------------------------------- synthesize_batch


def jax_draws(key, batch, *, speech_in=None, fixed_rir=False, fixed_speech=False, rt60_range=None,
              radius_range=None, theta=None, radius=None, snr_range=None, snr_clean_prob=0.0) -> SynthDraws:
    """The draws JAX's ``synthesize_batch`` takes from ``key``
    (``synth.py:473-640``), replayed as the port's :class:`SynthDraws`."""
    k_theta, k_speech, k_rt60 = jax.random.split(key, 3)
    u = jax.random.uniform
    first = (lambda a: jnp.broadcast_to(a[:1], a.shape)) if fixed_rir else (lambda a: a)
    if theta is not None:
        th = jnp.broadcast_to(jnp.asarray(theta, jnp.float32), (batch,))
    else:
        th = first(u(k_theta, (batch,), minval=-jnp.pi, maxval=jnp.pi))
    if radius is not None:
        r, r_hi = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (batch,)), float(np.max(radius))
    elif radius_range is not None:
        r = first(u(jax.random.fold_in(key, 7), (batch,), minval=radius_range[0], maxval=radius_range[1]))
        r_hi = float(radius_range[1])
    else:
        r, r_hi = jnp.full((batch,), JSMOKE.R), float(JSMOKE.R)
    sp = speech_in if speech_in is not None else jspeech.synthetic_speech_batch(
        k_speech, batch, JSMOKE.audio_samples, JSMOKE.fs)
    if fixed_speech:
        sp = jnp.broadcast_to(sp[:1], sp.shape)
    rt60 = None if rt60_range is None else first(u(k_rt60, (batch,), minval=rt60_range[0], maxval=rt60_range[1]))
    snr_db = noise = clean = None
    if snr_range is not None:
        snr_db = u(jax.random.fold_in(key, 11), (batch,), minval=snr_range[0], maxval=snr_range[1])
        noise = jax.random.normal(jax.random.fold_in(key, 13), (batch, JSMOKE.audio_samples))
        if snr_clean_prob:
            clean = u(jax.random.fold_in(key, 19), (batch,)) < snr_clean_prob
    opt = lambda a: None if a is None else t_(a)
    return SynthDraws(t_(th), t_(r), t_(sp), opt(rt60), opt(snr_db), opt(noise), opt(clean), r_hi)


def ratio_shape_err(got, want, echoed):
    """rir_spec is ill-conditioned: its max-normalization divides by
    |speech/echoed| at the bin of the smallest echoed power, 1e-9 of the
    median in some samples, where float32 rounding of the echoed spectrum
    moves the maximum. So a sample's scale is arbitrary in float32 (JAX's own
    lies up to 1.79x off float64 at these draws, the port's 2.63x) and is
    divided out: each sample's median ratio over the bins whose echoed power
    exceeds 1e-3 of its max, then the largest relative difference on those
    bins. Returns (that difference, the scales)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    errs, scales = [], []
    for b in range(got.shape[0]):
        mask = echoed[b] >= 1e-3 * echoed[b].max()
        scale = np.median(got[b][mask] / want[b][mask])
        errs.append(np.max(np.abs(got[b][mask] - scale * want[b][mask]) / np.abs(scale * want[b][mask])))
        scales.append(scale)
    return max(errs), scales


def assert_batch_matches(got: SampleBatch, want: list):
    """Field by field against JAX: speech_spec within 1e-5 of the max,
    echoed_spec and wiener_est within 1e-4 (the RIR's float32 rounding, 1e-5
    of its max, passes into them), fs, theta and radius exact, and rir_spec
    within rtol 1e-2 once each sample's scale is divided out
    (:func:`ratio_shape_err`; measured up to 2.6e-3), with a maximum of 1."""
    w = dict(zip(FIELDS, want))
    for name in ("fs", "theta", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), w[name], err_msg=name)
    assert got.fs.dtype == torch.int32
    for name, tol in (("speech_spec", 1e-5), ("echoed_spec", 1e-4), ("wiener_est", 1e-4)):
        g = getattr(got, name)
        assert g.shape == w[name].shape and g.dtype == torch.float32, name
        assert rel_err(g, w[name]) < tol, (name, rel_err(g, w[name]))
    err, _ = ratio_shape_err(got.rir_spec, w["rir_spec"], w["echoed_spec"])
    assert err < 1e-2, err
    assert got.rir_spec.dtype == torch.float32 and float(got.rir_spec.max()) <= 1.0 + 1e-5


CASES = {
    "default": {},
    "rt60_range": {"rt60_range": (0.2, 0.6)},
    "radius_range": {"radius_range": (0.5, 1.2)},
    "given geometry": {"theta": np.asarray([0.1, -3.0, 2.0, 1.1], np.float32),
                       "radius": np.asarray([0.4, 1.3, 0.9, 0.7], np.float32)},
    "snr with clean samples": {"snr_range": (0.0, 20.0), "snr_clean_prob": 0.5},
    "fixed rir and rt60_range": {"fixed_rir": True, "rt60_range": (0.3, 0.5)},
    "fixed speech": {"fixed_speech": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_synthesize_from_draws_matches_jax(case):
    opts = CASES[case]
    key = jax.random.PRNGKey(list(CASES).index(case) + 30)
    want = jax_fields(jsynth.synthesize_batch(key, B, JSMOKE, **opts))
    draws = jax_draws(key, B, **opts)
    got = data.synthesize_from_draws(draws, SMOKE, fixed_rir=opts.get("fixed_rir", False))
    assert_batch_matches(got, want)
    if "snr_range" in opts:
        clean = draws.clean.numpy()
        assert 0 < clean.sum() < B  # the key gives both kinds
        quiet = data.synthesize_from_draws(draws._replace(snr_db=None, noise=None, clean=None), SMOKE)
        assert torch.equal(quiet.echoed_spec[clean], got.echoed_spec[clean])
        assert not torch.equal(quiet.echoed_spec[~clean], got.echoed_spec[~clean])


def test_unculled_rir_lattice_gives_the_same_batch():
    """``geom_cull`` drops only images that cannot reach the window: the
    whole-room lattice gives the same batch within float32 rounding."""
    draws = jax_draws(jax.random.PRNGKey(40), B, radius_range=(0.5, 1.2))
    boxed = data.synthesize_from_draws(draws, SMOKE)
    room = data.synthesize_from_draws(draws, SMOKE, geom_cull=False)
    assert rel_err(room.echoed_spec, boxed.echoed_spec) < 1e-5


@pytest.mark.parametrize("opts,match", [
    ({"radius": 1.0, "radius_range": (0.5, 1.0)}, "excludes radius_range"),
    ({"radius_range": (0.0, 1.0)}, "0 < lo <= hi"),
    ({"radius_range": (0.5, 1.5)}, "max in-room source radius"),
    ({"snr_range": (10.0, 0.0)}, "lo <= hi"),
    ({"snr_range": (0.0, 10.0), "snr_clean_prob": 1.5}, r"\[0, 1\]"),
    ({"snr_clean_prob": 0.5}, "requires snr_range"),
])
def test_synthesize_batch_validation_errors_match_jax(opts, match):
    with pytest.raises(ValueError, match=match):
        jsynth.synthesize_batch(jax.random.PRNGKey(0), B, JSMOKE, **opts)
    with pytest.raises(ValueError, match=match):
        data.synthesize_batch(torch.Generator(), B, SMOKE, device="cpu", **opts)


def test_draws_follow_one_order_whatever_the_options():
    """An option changes no other draw, and giving the geometry a random run
    drew reproduces that run bitwise (the property JAX's fold_in streams
    give; bitwise where the given radii bound the cull as the draw did, here
    the config's R)."""
    g = lambda: torch.Generator().manual_seed(9)
    plain = data.draw_synthesis(g(), B, SMOKE)
    noisy = data.draw_synthesis(g(), B, SMOKE, snr_range=(0.0, 10.0), snr_clean_prob=0.5)
    ranged = data.draw_synthesis(g(), B, SMOKE, rt60_range=(0.2, 0.6), radius_range=(0.5, 1.2))
    for d in (noisy, ranged):
        assert torch.equal(d.theta, plain.theta) and torch.equal(d.speech, plain.speech)
    assert torch.equal(ranged.rt60, 0.2 + 0.4 * data.draw_synthesis(g(), B, SMOKE, rt60_range=(0.0, 1.0)).rt60)
    assert float(noisy.snr_db.min()) >= 0.0 and noisy.noise.shape == (B, SMOKE.audio_samples)
    random_run = data.synthesize_batch(g(), B, SMOKE, device="cpu")
    replay = data.synthesize_batch(g(), B, SMOKE, theta=random_run.theta, radius=random_run.radius, device="cpu")
    for name, a, b in zip(FIELDS, random_run, replay):
        assert torch.equal(a, b), name
    fixed = data.draw_synthesis(g(), B, SMOKE, fixed_rir=True, fixed_speech=True, rt60_range=(0.2, 0.6))
    for a in (fixed.theta, fixed.rt60, fixed.speech):
        assert torch.equal(a, a[:1].expand(a.shape))


def test_sensor_noise_meets_the_drawn_snr():
    """The noise is scaled to each sample's own power: the measured SNR is the
    drawn one within the white noise's own sampling spread (0.3 dB at 80,000
    samples), and clean samples are unchanged."""
    g = torch.Generator().manual_seed(2)
    echoed = speech.synthetic_speech_batch(g, 6, 80000) * torch.linspace(0.1, 2.0, 6)[:, None]
    snr_db = torch.tensor([0.0, 5.0, 10.0, 20.0, 30.0, 40.0])
    noise = torch.randn(6, 80000, generator=g)
    clean = torch.tensor([False, False, True, False, False, True])
    noisy = data.synth.add_sensor_noise(echoed, snr_db, noise, clean)
    assert torch.equal(noisy[clean], echoed[clean])
    measured = 10 * torch.log10(echoed.square().mean(1) / (noisy - echoed).square().mean(1))
    np.testing.assert_allclose(measured[~clean].numpy(), snr_db[~clean].numpy(), atol=0.3)


def test_synthesis_device_rules(monkeypatch):
    """Synthesis runs on the card unless asked for the CPU, raises without
    one, and its generator must lie on its device."""
    with pytest.raises(ValueError, match="generator lies on"):
        data.synthesize_batch(torch.Generator(), B, SMOKE, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        data.synthesize_batch(torch.Generator(), B, SMOKE)
    with pytest.raises(RuntimeError, match="cuda"):
        data.make_dataset(torch.Generator(), 4, SMOKE)
    with pytest.raises(RuntimeError, match="cuda"):
        generate_dataset.main(["--smoke", "--out-dir", "unused"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_pipeline.main(["--smoke", "--store-dir", "unused"])


def test_full_size_batch_shapes():
    """At the dataset's geometry the fields have the reference's shapes
    (201 bins x 500 frames of 501, 6400-tap RIRs), one sample."""
    b = data.synthesize_batch(torch.Generator().manual_seed(1), 1, data.DatasetConfig(), device="cpu")
    assert b.speech_spec.shape == b.rir_spec.shape == b.echoed_spec.shape == (1, 201, 500)
    assert b.wiener_est.shape == (1, 201) and b.fs.tolist() == [16000] and b.radius.tolist() == [1.0]
    assert all(bool(torch.isfinite(a.float()).all()) for a in b)


def test_observed_power_spec_and_geometry_helpers_match_jax():
    wave = np.random.default_rng(3).standard_normal((2, 3200)).astype(np.float32)
    want = np.asarray(jsynth.observed_power_spec(jnp.asarray(wave), JSMOKE))
    got = data.observed_power_spec(t_(wave), SMOKE)
    assert got.shape == (2, 33, 100) and rel_err(got, want) < 1e-5
    cfg, jcfg = data.DatasetConfig(), jdata.DatasetConfig()
    assert data.max_source_radius(cfg) == jsynth.max_source_radius(jcfg) == 1.5
    for r in (0.5, 1.0, 1.4):
        assert data.geometry_boxes(cfg, r) == jsynth.geometry_boxes(jcfg, r)


# ---------------------------------------------------------------- datasets


def _pair(seed, n=5):
    """The same random fields as a JAX SampleBatch and a port SampleBatch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.exponential(size=(n, 33, 100)).astype(np.float32) for _ in range(3)]
    arrs += [np.full(n, 16000, np.int32), rng.uniform(-np.pi, np.pi, n).astype(np.float32),
             rng.exponential(size=(n, 33)).astype(np.float32), np.full(n, 1.0, np.float32)]
    return jsynth.SampleBatch(*(jnp.asarray(a) for a in arrs)), SampleBatch(*(torch.from_numpy(a) for a in arrs))


@pytest.mark.parametrize("keep,dtype", [(("speech_spec",), None), (("rir_spec", "wiener_est"), "bfloat16")])
def test_prune_batch_matches_jax(keep, dtype):
    jb, tb = _pair(1)
    want = jax_fields(jsynth.prune_batch(jb, keep, None if dtype is None else jnp.bfloat16))
    got = data.prune_batch(tb, keep, None if dtype is None else torch.bfloat16)
    for name, g, w in zip(FIELDS, got, want):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=name)


def test_make_dataset_fills_its_buffer_in_generator_order(tmp_path):
    """Batches of 2 over 5 rows (a short last batch), one generator in turn:
    the rows are the batches synthesize_batch makes from the same generator;
    a speech pool's utterances are drawn per sample; keep_fields and
    store_dtype prune as prune_batch."""
    g = lambda: torch.Generator().manual_seed(4)
    ds = data.make_dataset(g(), 5, SMOKE, batch=2, device="cpu", rt60_range=(0.3, 0.5))
    gen = g()
    parts = [data.synthesize_batch(gen, b, SMOKE, device="cpu", rt60_range=(0.3, 0.5)) for b in (2, 2, 1)]
    for name, got, *want in zip(FIELDS, ds, *parts):
        assert torch.equal(got, torch.cat(want)), name

    pool = speech.synthetic_speech_batch(torch.Generator().manual_seed(8), 3, SMOKE.audio_samples).numpy()
    small = data.make_dataset(g(), 5, SMOKE, batch=2, device="cpu", speech_pool=pool,
                              keep_fields=("speech_spec",), store_dtype=torch.bfloat16)
    assert small.speech_spec.dtype == torch.bfloat16 and small.echoed_spec.shape == (5, 0, 0)
    assert small.wiener_est.shape == (5, 0) and small.theta.dtype == torch.float32
    pool_specs = data.observed_power_spec(torch.from_numpy(pool), SMOKE).to(torch.bfloat16)
    for row in small.speech_spec:
        assert any(torch.equal(row, p) for p in pool_specs)
    with pytest.raises(ValueError, match="speech_pool length"):
        data.make_dataset(g(), 2, SMOKE, device="cpu", speech_pool=pool[:, :100])
    with pytest.raises(ValueError, match="positive"):
        data.make_dataset(g(), 0, SMOKE, device="cpu")


def test_reference_pt_format_round_trip(tmp_path):
    """The reference's ``<i>.pt`` 6-tuples (theta a float64 (1,) tensor, fs an
    int), read back by the port's SpecsDataset and by JAX's."""
    _, tb = _pair(2, n=3)
    data.save_dataset_reference_format(str(tmp_path), tb, SMOKE)
    item = torch.load(tmp_path / "1.pt", weights_only=False)
    assert len(item) == 6 and isinstance(item[3], int)
    assert item[4].dtype == torch.float64 and item[4].shape == (1,)
    back = data.SpecsDataset(str(tmp_path)).load_all()
    for name in ("speech_spec", "rir_spec", "echoed_spec", "wiener_est", "fs"):
        assert torch.equal(getattr(back, name), getattr(tb, name).to(getattr(back, name).dtype)), name
    np.testing.assert_allclose(back.theta.numpy(), tb.theta.numpy())
    jds = jdata.SpecsDataset(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jds[2][0]), tb.speech_spec[2].numpy())
    assert jds.config.to_reference_dict() == SMOKE.to_reference_dict()


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_generate_dataset_writes_a_dataset(tmp_path, capsys, fmt):
    out = tmp_path / "data"
    generate_dataset.main(["--smoke", "--device", "cpu", "--out-dir", str(out), "--dataset-size", "6",
                           "--format", fmt, "--seed", "3", "--rt60-range", "0.3", "0.5"])
    printed = capsys.readouterr().out
    assert "samples/s" in printed and "wrote 6 samples" in printed
    loaded = data.SpecsDataset(str(out)).load_all()
    want = data.make_dataset(torch.Generator().manual_seed(3), 6, cli_pipeline.smoke_config(), device="cpu",
                             rt60_range=(0.3, 0.5))
    assert torch.equal(loaded.echoed_spec, want.echoed_spec) and torch.equal(loaded.theta, want.theta)


def test_run_pipeline_synthesizes_from_its_seed_then_resumes(tmp_path, capsys):
    """``run_pipeline`` without ``--data-dir``: both sets synthesized on the
    CPU from ``--seed`` at the smoke geometry, width 1/16; the same flags
    synthesize the same sets again, and ``--resume`` skips every stage."""
    argv = ["--smoke", "--device", "cpu", "--width-scale", "0.0625", "--updates", "2", "--dataset-size", "8",
            "--val-size", "4", "--seed", "3", "--store-dir", str(tmp_path / "store"), "--joint-location",
            "--snr-range", "10", "30", "--snr-clean-prob", "0.5"]
    cli_pipeline.main(argv)
    first = capsys.readouterr().out
    assert "joint location evaluation" in first and '"num_samples": 4' in first
    args = cli_pipeline.build_parser().parse_args(argv)
    _, train, val = cli_pipeline.load_datasets(args)
    _, train2, val2 = cli_pipeline.load_datasets(cli_pipeline.build_parser().parse_args(argv))
    assert train.speech_spec.shape == (8, 33, 100) and val.theta.shape == (4,)
    for a, b in zip((*train, *val), (*train2, *val2)):
        assert torch.equal(a, b)
    cli_pipeline.main(argv + ["--resume"])
    again = capsys.readouterr().out
    for stage in ("speech", "rir", "echoed", "finetune", "location", "location_joint"):
        assert f"[pipeline] stage '{stage}' complete in store — skipping" in again, stage
    with pytest.raises(SystemExit):
        cli_pipeline.main(["--smoke", "--device", "cpu", "--snr-clean-prob", "0.5"])


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_synthesis_on_card_is_bitwise_repeatable_and_matches_cpu(card):
    """Two synthesize_batch calls from equal generators on the card are
    bitwise equal; the card's batch from a set of draws matches the port in
    float64 on the CPU from the same draws within phase 11's limits."""
    opts = dict(rt60_range=(0.2, 0.6), snr_range=(5.0, 20.0))
    runs = [data.synthesize_batch(torch.Generator(card).manual_seed(5), B, SMOKE, device=card, **opts)
            for _ in range(2)]
    for name, a, b in zip(FIELDS, *runs):
        assert torch.equal(a, b), name
    draws = data.draw_synthesis(torch.Generator(card).manual_seed(6), B, SMOKE, **opts)
    got = data.synthesize_from_draws(draws, SMOKE)
    ref = data.synthesize_from_draws(draws.to("cpu", torch.float64), SMOKE)
    for name in ("speech_spec", "echoed_spec", "wiener_est"):
        assert rel_err(getattr(got, name).cpu(), getattr(ref, name)) < CARD_LIMITS[name], name
    err, _ = ratio_shape_err(got.rir_spec.cpu(), ref.rir_spec, ref.echoed_spec.numpy())
    assert err < CARD_LIMITS["rir_spec"]
