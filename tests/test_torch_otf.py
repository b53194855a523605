"""The port's RIR bank, bank and mixed synthesis, on-the-fly training and the
joint bank-then-exact recipe, on the CPU, against the JAX package:

* ``make_rir_bank`` against JAX's for the 2-D, 3-D and 4-D layouts, the
  coarse-grid warning and the layout errors (JAX ``tests/test_data.py:429-611``);
* bank and mixed synthesis from JAX's own index and mask draws (its
  ``split`` / ``fold_in`` streams, replayed into the port's deterministic
  core as ``test_torch_synth.py`` replays its draws), and the port's draw
  step for what it promises (labels on the gathered cell, the continuous
  draws unchanged, the bank samples regenerated exactly from their labels;
  JAX ``tests/test_data.py:449-800``);
* the on-the-fly ``Trainer``: fit without a training set, the speech pool's
  provenance, the errors, the frozen-latent cache of the validation set
  only, and a resume bitwise equal to an uninterrupted run (JAX
  ``tests/test_train.py:224-297``);
* ``fit_joint_recipe``: its legs, step numbering, store tags, guards and
  mixed polish (JAX ``tests/test_train.py:569-690``), a resume inside each leg
  bitwise equal to an uninterrupted run, and the CLI's flags.

The geometry is the JAX CLIs' smoke geometry (512-tap RIRs, 0.2 s of audio,
33 bins x 100 frames), widths ``1/32``. Tolerances are stated at each assert.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import synth as jsynth
from acoustic_locating_vq_vae_torch import data
from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli_pipeline
from acoustic_locating_vq_vae_torch.data import synth
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask,
    JointLocationTask,
    Preempted,
    SpeechVQVAETask,
    Trainer,
    fit_joint_recipe,
)
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_torch_kernels import assert_bitwise
from test_torch_synth import JSMOKE, SMOKE, assert_batch_matches, jax_draws, jax_fields, rel_err, t_

WS = 1 / 32
CHUNK = 2048
RADII = (0.7, 1.2)
T60S = (0.3, 0.5)
# make_rir_bank's layouts at JAX's test sizes: (n_theta, rt60s, radii)
LAYOUTS = {"2-D": (8, None, None), "3-D": (4, T60S, None), "4-D": (8, T60S, RADII)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU ops run faster on one thread, alone and beside the
    suite's other workers; the setting comes back after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def banks():
    """{layout: (JAX's bank as numpy, the port's bank)}, built with the JAX tests' chunk 2048 and batch 4."""
    out = {}
    for name, (n, rt60s, radii) in LAYOUTS.items():
        want = np.asarray(jsynth.make_rir_bank(JSMOKE, n_theta=n, rt60s=rt60s, radii=radii, chunk=CHUNK, batch=4))
        got = data.make_rir_bank(SMOKE, n_theta=n, rt60s=rt60s, radii=radii, chunk=CHUNK, batch=4, device="cpu")
        out[name] = want, got
    return out


# ---------------------------------------------------------------- the bank


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_make_rir_bank_matches_jax(banks, layout):
    """Each layout's shape, and its RIRs within 1e-4 of the bank's max from
    JAX's, the limit of ``test_torch_dsp.py``'s boxed-lattice RIR test (read
    2.4e-5 for the 2-D bank: JAX's float32 lies 1.6e-5 from the port in
    float64, the port's 1.5e-5); the grid is JAX's."""
    want, got = banks[layout]
    n, rt60s, radii = LAYOUTS[layout]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert got.shape == {"2-D": (n, 512), "3-D": (2, n, 512), "4-D": (2, 2, n, 512)}[layout]
    assert rel_err(got, want) < 1e-4
    np.testing.assert_array_equal(data.bank_thetas(n), jsynth.bank_thetas(n))


def test_bank_rows_are_generate_rir_batch_at_the_grid():
    """A bank row is bitwise ``generate_rir_batch`` at its grid angle, T60
    and radius, in the same batch of angles, with the cull boxed at the radius."""
    bank = data.make_rir_bank(SMOKE, n_theta=8, rt60s=T60S, radii=RADII, chunk=CHUNK, batch=4, device="cpu")
    thetas = torch.from_numpy(data.bank_thetas(8))
    recv, room = torch.tensor(SMOKE.receiver_position), torch.tensor(SMOKE.room_dimensions)
    for t, r in ((1, 0), (0, 1)):
        src = data.synth.source_coordinates(thetas, recv, room, radius=RADII[r], z_loc=SMOKE.Z_LOC_SOURCE)
        sbox, rbox = data.geometry_boxes(SMOKE, RADII[r])
        rows = synth.generate_rir_batch(src[4:8], recv, rt60=T60S[t], room=SMOKE.room_dimensions, nsample=512,
                                        fs=16000.0, c=SMOKE.c, chunk=CHUNK, source_box=sbox, receiver_box=rbox)
        assert torch.equal(bank[t, r, 4:8], rows)


def test_bank_radius_checks_and_coarse_grid_warning():
    """Radii must keep the circle in the room (JAX's error); a grid coarser
    than 5 cm warns (JAX's warning), 4 cm and one radius stay silent."""
    import warnings

    cfg = data.DatasetConfig(n_sample=256, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
    jcfg = jsynth.DatasetConfig(n_sample=256, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
    for make, c, kw in ((jsynth.make_rir_bank, jcfg, {}), (data.make_rir_bank, cfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="leave the room"):
            make(c, n_theta=4, radii=(0.8, 1.5), chunk=CHUNK, batch=4, **kw)
        with pytest.warns(UserWarning, match="OFF-grid"):
            make(c, n_theta=4, radii=(0.8, 1.1), chunk=CHUNK, batch=4, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        data.make_rir_bank(cfg, n_theta=4, radii=(0.8, 0.84), chunk=CHUNK, batch=4, device="cpu")
        data.make_rir_bank(cfg, n_theta=4, radii=(0.8,), chunk=CHUNK, batch=4, device="cpu")


# ---------------------------------------------------------------- bank and mixed synthesis, JAX's draws


def jax_bank_draws(key, batch, jbank, radii=None, fixed_rir=False, **opts) -> data.SynthDraws:
    """The draws of JAX's pure-bank ``synthesize_batch`` (``synth.py:473-558``):
    the angle cell from ``k_theta``, the T60 cell from ``k_rt60``, the radius
    cell from ``fold_in(key, 7)``, as the port's draws with bank cells (labels
    set by the caller)."""
    k_theta, _, k_rt60 = jax.random.split(key, 3)
    n_t60, n_r, n_theta = (jbank[None, None] if jbank.ndim == 2 else jbank[:, None] if jbank.ndim == 3
                           else jbank).shape[:3]
    first = (lambda a: jnp.broadcast_to(a[:1], a.shape)) if fixed_rir else (lambda a: a)
    idx = first(jax.random.randint(k_theta, (batch,), 0, n_theta))
    t60 = first(jax.random.randint(k_rt60, (batch,), 0, n_t60)) if jbank.ndim > 2 else jnp.zeros(batch, jnp.int32)
    r = first(jax.random.randint(jax.random.fold_in(key, 7), (batch,), 0, n_r)) if radii is not None \
        else jnp.zeros(batch, jnp.int32)
    cells = torch.stack([t_(t60), t_(r), t_(idx)], 1).long()
    return jax_draws(key, batch, **opts)._replace(bank_index=cells)


BANK_CASES = {
    "2-D with sensor noise": ("2-D", dict(snr_range=(0.0, 20.0), snr_clean_prob=0.5)),
    "3-D T60 cells": ("3-D", {}),
    "4-D radius cells": ("4-D", {}),
    "4-D fixed rir": ("4-D", dict(fixed_rir=True)),
}


@pytest.mark.parametrize("case", list(BANK_CASES))
def test_bank_synthesis_matches_jax(banks, case):
    """Pure-bank synthesis from JAX's cell draws against JAX's batch (the
    tolerances of ``test_torch_synth.assert_batch_matches``), and the port's
    labels of those cells (its bank's own angles, ``bank_thetas``) within
    1e-6 rad of JAX's float32 formula, the radius labels equal."""
    layout, opts = BANK_CASES[case]
    jbank, bank = banks[layout]
    radii = RADII if layout == "4-D" else None
    key = jax.random.PRNGKey(list(BANK_CASES).index(case) + 50)
    bank_kw = {"rir_bank_radii": jnp.asarray(radii, jnp.float32)} if radii else {}
    want = jsynth.synthesize_batch(key, 6, JSMOKE, rir_bank=jnp.asarray(jbank), rir_chunk=CHUNK, **bank_kw, **opts)
    draws = jax_bank_draws(key, 6, jbank, radii, **opts)
    draws = draws._replace(theta=t_(want.theta), radius=t_(want.radius))
    got = data.synthesize_from_draws(draws, SMOKE, fixed_rir=opts.get("fixed_rir", False), rir_bank=bank)
    assert_batch_matches(got, jax_fields(want))
    t60, r, th = draws.bank_index.unbind(1)
    np.testing.assert_allclose(data.bank_thetas(bank.shape[-2])[th.numpy()], np.asarray(want.theta), atol=1e-6)
    if radii:
        np.testing.assert_array_equal(np.asarray(RADII, np.float32)[r.numpy()], np.asarray(want.radius))
        assert len(set(r.tolist())) == (1 if opts.get("fixed_rir") else 2)  # seed-pinned: both radii drawn


@pytest.mark.parametrize("layout", ["2-D", "4-D"])
def test_mixed_synthesis_matches_jax(banks, layout):
    """Per-sample mixed bank/exact synthesis (``bank_mix_prob`` 0.5, B = 16):
    JAX's continuous draws snapped by the port's ``snap_to_bank`` give JAX's
    labels (angles within 1e-6 rad, radii equal); with JAX's mask
    (``fold_in(key, 23)``) and bank T60 cells (``fold_in(key, 29)``) the batch
    matches JAX's within ``assert_batch_matches``'s tolerances."""
    jbank, bank = banks[layout]
    opts = dict(rt60_range=(0.3, 0.5), radius_range=(0.6, 1.3)) if layout == "4-D" else {}
    bank_kw = {"rir_bank_radii": jnp.asarray(RADII, jnp.float32)} if layout == "4-D" else {}
    key = jax.random.PRNGKey(21)
    want = jsynth.synthesize_batch(key, 16, JSMOKE, rir_bank=jnp.asarray(jbank), bank_mix_prob=0.5, rir_chunk=CHUNK,
                                   **bank_kw, **opts)
    exact = jax_draws(key, 16, **opts)
    use = t_(jax.random.uniform(jax.random.fold_in(key, 23), (16,)) < 0.5)
    assert 0 < int(use.sum()) < 16  # the key gives both kinds
    n_t60 = bank.shape[0] if bank.dim() > 2 else 1
    t60 = t_(jax.random.randint(jax.random.fold_in(key, 29), (16,), 0, n_t60)).long()
    radii = torch.tensor(RADII) if layout == "4-D" else None
    t_idx, r_idx, th_grid, r_grid = synth.snap_to_bank(exact.theta, exact.radius, bank.shape[-2], radii)
    np.testing.assert_allclose(torch.where(use, th_grid, exact.theta).numpy(), np.asarray(want.theta), atol=1e-6)
    np.testing.assert_array_equal(torch.where(use, r_grid, exact.radius).numpy(), np.asarray(want.radius))
    draws = exact._replace(theta=t_(want.theta), radius=t_(want.radius), use_bank=use,
                           bank_index=torch.stack([t60, r_idx, t_idx], 1))
    assert_batch_matches(data.synthesize_from_draws(draws, SMOKE, rir_bank=bank), jax_fields(want))


def test_bank_draws_keep_every_other_draw_and_label_the_gathered_cell(banks):
    """The port's draw step with a bank: the speech, noise and continuous
    draws are those of the same generator without one; pure-bank labels are
    the gathered cell's angle and radius; in a mixed batch the exact samples
    are bitwise those of the pure-exact batch and the bank samples sit in
    the cell their continuous draw fell in."""
    _, bank = banks["4-D"]
    g = lambda: torch.Generator().manual_seed(31)
    opts = dict(rt60_range=(0.3, 0.5), radius_range=(0.6, 1.3), snr_range=(5.0, 25.0))
    plain = data.draw_synthesis(g(), 16, SMOKE, **opts)
    pure = data.draw_synthesis(g(), 16, SMOKE, rir_bank=bank, rir_bank_radii=RADII, snr_range=(5.0, 25.0))
    mixed = data.draw_synthesis(g(), 16, SMOKE, rir_bank=bank, rir_bank_radii=RADII, bank_mix_prob=0.5, **opts)
    for d in (pure, mixed):
        assert torch.equal(d.speech, plain.speech) and torch.equal(d.noise, plain.noise)
    t60, r, th = pure.bank_index.unbind(1)
    assert torch.equal(pure.theta, torch.from_numpy(data.bank_thetas(8))[th])
    assert torch.equal(pure.radius, torch.tensor(RADII)[r]) and pure.rt60 is None and pure.use_bank is None
    assert len(set(t60.tolist())) == len(set(r.tolist())) == 2 and len(set(th.tolist())) > 4
    use = mixed.use_bank
    assert 0 < int(use.sum()) < 16
    assert torch.equal(mixed.theta[~use], plain.theta[~use]) and torch.equal(mixed.radius[~use], plain.radius[~use])
    cell = torch.floor((plain.theta[use] + np.pi) / (2 * np.pi / 8)).long()
    assert torch.equal(mixed.bank_index[use, 2], cell)
    got = data.synthesize_from_draws(mixed, SMOKE, rir_chunk=CHUNK, rir_bank=bank)
    ref = data.synthesize_from_draws(plain, SMOKE, rir_chunk=CHUNK)
    assert torch.equal(got.echoed_spec[~use], ref.echoed_spec[~use])
    assert not torch.equal(got.echoed_spec[use], ref.echoed_spec[use])


def test_bank_samples_regenerate_from_their_labels(banks):
    """Every bank sample of a pure and of a mixed batch, synthesized exactly
    at its labels (given angle and radius, its cell's T60): the RIRs within
    1e-5 of their max of the gathered ones (static against per-sample
    Sabine betas, a wider cull), the echoed spectrogram within 1e-4."""
    _, bank = banks["4-D"]
    for kw in ({}, dict(bank_mix_prob=0.5, rt60_range=(0.3, 0.5), radius_range=(0.6, 1.3))):
        draws = data.draw_synthesis(torch.Generator().manual_seed(8), 8, SMOKE, rir_bank=bank, rir_bank_radii=RADII,
                                    **kw)
        got = data.synthesize_from_draws(draws, SMOKE, rir_chunk=CHUNK, rir_bank=bank)
        use = draws.use_bank if draws.use_bank is not None else torch.ones(8, dtype=torch.bool)
        exact = draws._replace(rt60=torch.tensor(T60S)[draws.bank_index[:, 0]], bank_index=None, use_bank=None,
                               r_hi=max(RADII))
        h = data.rirs_from_draws(exact, SMOKE, rir_chunk=CHUNK)
        gathered = bank[tuple(draws.bank_index.unbind(1))]
        assert rel_err(h[use], gathered[use]) < 1e-5
        again = data.synthesize_from_draws(exact, SMOKE, rir_chunk=CHUNK)
        assert rel_err(again.echoed_spec[use], got.echoed_spec[use]) < 1e-4


BANK_ERRORS = [
    (dict(bank_mix_prob=0.5), "requires rir_bank"),
    (dict(rir_bank="2d", bank_mix_prob=1.0), "strictly between"),
    (dict(rir_bank="2d", bank_mix_prob=0.5, fixed_rir=True), "excludes fixed_rir"),
    (dict(rir_bank="2d", bank_mix_prob=0.5, radius_range=(0.6, 1.3)), "radius-gridded"),
    (dict(rir_bank="3d", rt60_range=(0.2, 0.6)), "rt60_range"),
    (dict(rir_bank="2d", radius_range=(0.6, 1.3)), "excludes radius_range"),
    (dict(rir_bank="2d", theta=np.zeros(2, np.float32)), "theta excludes rir_bank"),
    (dict(rir_bank="4d"), "rir_bank_radii"),
    (dict(rir_bank_radii=RADII), "requires rir_bank"),
    (dict(rir_bank="4d", rir_bank_radii=(0.8, 1.1, 1.4)), "radius axis"),
    (dict(rir_bank="4d", rir_bank_radii=RADII, radius=np.full(2, 0.8, np.float32)), "given radius excludes"),
    (dict(rir_bank="1d", rir_bank_radii=RADII), "ndim"),
    (dict(rir_bank="3d", rir_bank_radii=RADII), "4-D"),
    (dict(rir_bank="5d"), "ndim"),
    (dict(rir_bank="short"), "n_sample"),
]


@pytest.mark.parametrize("opts,match", BANK_ERRORS)
def test_bank_option_errors_match_jax(opts, match):
    """Every bank option error of JAX's ``synthesize_batch``, with its words,
    from both packages (zero banks: the checks read shapes only)."""
    shapes = {"1d": (512,), "2d": (8, 512), "3d": (2, 8, 512), "4d": (2, 2, 8, 512), "5d": (1, 2, 2, 8, 512),
              "short": (8, 256)}
    opts = dict(opts)
    if "rir_bank" in opts:
        shape = shapes[opts.pop("rir_bank")]
        opts_j, opts_t = dict(opts, rir_bank=jnp.zeros(shape)), dict(opts, rir_bank=torch.zeros(shape))
    else:
        opts_j, opts_t = dict(opts), dict(opts)
    if "rir_bank_radii" in opts:
        opts_j["rir_bank_radii"] = jnp.asarray(opts["rir_bank_radii"], jnp.float32)
    with pytest.raises(ValueError, match=match):
        jsynth.synthesize_batch(jax.random.PRNGKey(0), 2, JSMOKE, rir_chunk=CHUNK, **opts_j)
    with pytest.raises(ValueError, match=match):
        data.synthesize_batch(torch.Generator(), 2, SMOKE, rir_chunk=CHUNK, device="cpu", **opts_t)


def test_make_dataset_draws_from_the_bank(banks):
    """``make_dataset`` with a bank (the CLI's bank-drawn validation set):
    the rows are the batches ``synthesize_batch`` makes from the same
    generator in turn, every label on the grid."""
    _, bank = banks["4-D"]
    kw = dict(rir_bank=bank, rir_bank_radii=RADII, rir_chunk=CHUNK)
    ds = data.make_dataset(torch.Generator().manual_seed(4), 5, SMOKE, batch=2, device="cpu", **kw)
    gen = torch.Generator().manual_seed(4)
    parts = [data.synthesize_batch(gen, b, SMOKE, device="cpu", **kw) for b in (2, 2, 1)]
    for name, got, *want in zip(data.SampleBatch._fields, ds, *parts):
        assert torch.equal(got, torch.cat(want)), name
    assert set(ds.radius.tolist()) <= set(torch.tensor(RADII).tolist())
    assert all(float(t) in data.bank_thetas(8).tolist() for t in ds.theta)


# ---------------------------------------------------------------- the on-the-fly trainer


@pytest.fixture(scope="module")
def val_set():
    return data.make_dataset(torch.Generator().manual_seed(1), 8, SMOKE, batch=8, device="cpu", rir_chunk=CHUNK)


def _speech_trainer(store=None, seed=21, **kw):
    task = SpeechVQVAETask(config=SMOKE, width_scale=WS, batch_size=8, eval_every=5)
    return Trainer(task, device="cpu", seed=seed, verbose=False, on_the_fly=True,
                   checkpoint_dir=str(store) if store else None, **kw)


def test_on_the_fly_fit_and_its_errors(val_set):
    """No training set at all: 10 updates, 2 of them eval steps on the
    validation set, finite; the JAX Trainer's errors, the pool's from both."""
    tr = _speech_trainer(synth_kwargs=dict(rir_chunk=CHUNK))
    hist = tr.fit(None, val_set, num_updates=10).finalize()
    assert len(hist["train"]["loss"]) == 8 and len(hist["val"]["recon_error"]) == 2
    assert np.isfinite(hist["train"]["loss"]).all() and tr.step_count == 10
    resident = Trainer(tr.task, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="requires on_the_fly"):
        resident.fit(None, val_set, num_updates=2)
    with pytest.raises(ValueError, match="needs val_data"):
        _speech_trainer().fit(None, None, num_updates=2)
    pool = np.zeros((2, SMOKE.audio_samples), np.float32)
    jtask = jtrain.SpeechVQVAETask(config=JSMOKE, width_scale=WS, batch_size=8)
    with pytest.raises(ValueError, match="on_the_fly"):
        jtrain.Trainer(jtask, verbose=False, synth_kwargs=dict(speech_pool=pool))
    for kw in (dict(speech_pool=pool), dict(rir_bank=torch.zeros(8, 512))):
        with pytest.raises(ValueError, match="on_the_fly"):
            Trainer(tr.task, device="cpu", synth_kwargs=kw)
    with pytest.raises(ValueError, match="speech_pool length"):
        _speech_trainer(synth_kwargs=dict(speech_pool=pool[:, :100]))


def test_otf_speech_pool_provenance(banks):
    """``--wav-dir --on-the-fly``: every synthesized sample's speech
    spectrogram is a pool utterance's (within 1e-5 of its max; several
    utterances drawn), and the trainer's batches are bitwise those
    ``make_dataset`` draws from a generator seeded ``seed + 3`` with the same
    pool and bank (pool row first, then the batch)."""
    t = np.arange(SMOKE.audio_samples) / SMOKE.fs
    pool = np.stack([np.sin(2 * np.pi * f * t).astype(np.float32) for f in (450.0, 1300.0, 3100.0)])
    _, bank = banks["2-D"]
    tr = _speech_trainer(synth_kwargs=dict(rir_chunk=CHUNK, speech_pool=pool, rir_bank=bank))
    assert "speech_pool" not in tr.synth_kwargs and tr.rir_bank is bank  # held once, on the device
    got = [tr.otf_batch() for _ in range(2)]
    pool_specs = data.observed_power_spec(torch.from_numpy(pool), SMOKE)
    matched = set()
    for row in got[0].speech_spec:
        diffs = [rel_err(row, p) for p in pool_specs]
        assert min(diffs) < 1e-5
        matched.add(int(np.argmin(diffs)))
    assert len(matched) > 1
    want = data.make_dataset(torch.Generator().manual_seed(21 + 3), 16, SMOKE, batch=8, device="cpu",
                             speech_pool=pool, rir_bank=bank, rir_chunk=CHUNK)
    for name, a, b, w in zip(data.SampleBatch._fields, *got, want):
        assert torch.equal(torch.cat([a, b]), w), name


def test_otf_resume_is_bitwise(val_set, tmp_path, banks):
    """A preempted on-the-fly stage (mixed bank/exact draws, sensor noise)
    resumes bitwise: weights, Adam, and all three generators equal an
    uninterrupted run's; the checkpoint holds the synthesis generator."""
    _, bank = banks["4-D"]
    kw = dict(synth_kwargs=dict(rir_chunk=CHUNK, rir_bank=bank, rir_bank_radii=RADII, bank_mix_prob=0.5,
                                rt60_range=(0.3, 0.5), radius_range=(0.6, 1.3), snr_range=(0.0, 30.0)))
    straight = _speech_trainer(**kw)
    straight.fit(None, val_set, num_updates=8)
    tr = _speech_trainer(tmp_path, **kw)
    calls, step = [0], tr.step

    def stepping(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            tr.request_preemption()
        return step(*a, **k)

    tr.step = stepping
    with pytest.raises(Preempted):
        tr.fit(None, val_set, num_updates=8)
    assert "synth_generator" in StageStore(str(tmp_path)).load_stage("speech_3")
    again = _speech_trainer(tmp_path, **kw)
    again.fit(None, val_set, num_updates=8, resume=True)
    assert again.step_count == 8
    assert_bitwise(again.model.state_dict(), straight.model.state_dict(), "model")
    assert_bitwise(again.optimizer.state_dict(), straight.optimizer.state_dict(), "adam")
    for g in ("sample_generator", "jitter_generator", "synth_generator"):
        assert torch.equal(getattr(again, g).get_state(), getattr(straight, g).get_state()), g
    resident = Trainer(again.task, device="cpu", verbose=False, checkpoint_dir=str(tmp_path))
    assert resident.restore_latest() == 3  # a resident trainer reads an on-the-fly checkpoint
    otf = _speech_trainer(tmp_path / "other", **kw)
    otf.store.save_stage("speech_2", {"model": {}}, step=2)
    with pytest.raises(ValueError, match="no synthesis generator"):
        otf.restore_latest()


def test_otf_caches_only_the_validation_set(val_set):
    """``cache_frozen`` under on-the-fly training: the cache of the resident
    validation set is built, the synthesized batches run the frozen branches."""
    task = EchoedSpeechTask(config=SMOKE, width_scale=WS, batch_size=4, eval_every=2)
    tr = Trainer(task, device="cpu", seed=3, verbose=False, on_the_fly=True, cache_frozen=True,
                 synth_kwargs=dict(rir_chunk=CHUNK))
    built, steps, cache_of, step = [], [], tr.build_cache, tr.step
    tr.build_cache = lambda d: built.append(d) or cache_of(d)
    tr.step = lambda batch, train=True, cache=None: steps.append((train, cache is None)) or step(batch, train, cache)
    hist = tr.fit(None, val_set, num_updates=4).finalize()
    assert len(built) == 1 and built[0].speech_spec.shape[0] == 8
    assert steps == [(True, True), (False, False), (True, True), (False, False)]
    assert np.isfinite(hist["train"]["loss"]).all()


# ---------------------------------------------------------------- the joint recipe


@pytest.fixture(scope="module")
def composite():
    task = EchoedSpeechTask(config=SMOKE, width_scale=WS, batch_size=8, compat_vq_flatten=False)
    return Trainer(task, device="cpu", seed=40, verbose=False).model.state_dict()


def _recipe(store, val, composite, bank, synth_kw=None, **kw):
    task = JointLocationTask(config=SMOKE, width_scale=WS, batch_size=8, predict_radius=True, tail_weight=1.0)
    synth_kw = synth_kw or {}
    return fit_joint_recipe(
        task, 41, None, val, str(store) if store else None, composite, kw.pop("bank_updates", 4),
        kw.pop("num_updates", 10), exact_synth_kwargs=dict(rir_chunk=CHUNK, **synth_kw), verbose=False,
        on_the_fly=True, device="cpu", synth_kwargs=dict(rir_bank=bank, rir_chunk=CHUNK, **kw.pop("bank_kw", {})),
        **kw)


def test_fit_joint_recipe_legs_and_store(val_set, composite, banks, tmp_path, capsys):
    """One store, one step count: 10 updates over both legs, the boundary
    pinned as location_joint_4, the final only after the polish, the RIR
    branch seeded from the composite; leg 2 resumed through the store; the
    storeless run (leg 2 counts the remaining updates) ends bitwise equal."""
    _, bank = banks["2-D"]
    trainer, hist = _recipe(tmp_path, val_set, composite, bank)
    f = hist.finalize()
    assert trainer.step_count == 10 and len(f["train"]["location_error"]) == 10
    assert np.isfinite(f["train"]["location_error"]).all()
    tags = StageStore(str(tmp_path)).stages()
    assert tags["location_joint"]["metadata"]["final"] and tags["location_joint_4"]["step"] == 4
    assert torch.equal(trainer.model.state_dict()["rir_model._vq._embedding.weight"],
                       composite["rir_model._vq._embedding.weight"])
    assert trainer.rir_bank is None and trainer.synth_kwargs == dict(rir_chunk=CHUNK)  # the polish is exact
    storeless, hist2 = _recipe(None, val_set, composite, bank)
    assert len(hist2.finalize()["train"]["location_error"]) == 10
    assert_bitwise(storeless.model.state_dict(), trainer.model.state_dict(), "model")
    assert torch.equal(storeless.synth_generator.get_state(), trainer.synth_generator.get_state())


@pytest.mark.parametrize("kw,match", [
    (dict(bank_updates=12), "bank_updates"),
    (dict(polish_bank_prob=1.0), "polish_bank_prob"),
    (dict(no_bank=True), "RIR bank"),
    (dict(exact_bank=True), "must not carry"),
])
def test_fit_joint_recipe_guards_match_jax(kw, match):
    """The recipe's guards, with JAX's words, from both packages (they raise
    before any training)."""
    kw = dict(kw)
    no_bank, exact_bank = kw.pop("no_bank", False), kw.pop("exact_bank", False)
    common = dict(bank_updates=kw.pop("bank_updates", 4), num_updates=10, **kw)
    for pkg, task, bank, args in (
        (jtrain, jtrain.JointLocationTask(config=JSMOKE, width_scale=WS), jnp.zeros((8, 512)), (jax.random.PRNGKey(0),)),
        (None, JointLocationTask(config=SMOKE, width_scale=WS), torch.zeros(8, 512), (0,)),
    ):
        synth_kw = {} if no_bank else dict(rir_bank=bank)
        exact = dict(rir_bank=bank) if exact_bank else {}
        with pytest.raises(ValueError, match=match):
            if pkg is jtrain:
                pkg.fit_joint_recipe(task, *args, None, None, None, None, composite_params=None,
                                     exact_synth_kwargs=exact, on_the_fly=True, synth_kwargs=synth_kw, **common)
            else:
                fit_joint_recipe(task, *args, None, None, None, None, exact_synth_kwargs=exact, on_the_fly=True,
                                 synth_kwargs=synth_kw, device="cpu", **common)
    # a short polish after a longer bank leg warns, in both, before the bank check
    for call in (lambda: jtrain.fit_joint_recipe(jtrain.JointLocationTask(config=JSMOKE), jax.random.PRNGKey(0), None,
                                                 None, None, None, None, 8, 10),
                 lambda: fit_joint_recipe(JointLocationTask(config=SMOKE), 0, None, None, None, None, 8, 10)):
        with pytest.warns(UserWarning, match="re-convergence"), pytest.raises(ValueError, match="RIR bank"):
            call()


RUN_K = dict(bank_kw=dict(rir_bank_radii=RADII), synth_kw=dict(rt60_range=(0.3, 0.5), radius_range=(0.6, 1.3)),
             polish_bank_prob=0.5)


def test_mixed_polish_resumes_bitwise_inside_either_leg(val_set, composite, banks, tmp_path, monkeypatch):
    """Run K's shape at the smoke size: a 4-D bank with radii in leg 1, a
    mixed polish (``polish_bank_prob`` 0.5) over T60 and radius ranges in leg
    2. Preempted during update 2 (the bank leg) or 7 (the polish) and
    resumed with ``resume=True``, the run ends bitwise equal to an
    uninterrupted one: weights, Adam, step and all three generators."""
    _, bank = banks["4-D"]
    straight, hist = _recipe(tmp_path / "straight", val_set, composite, bank, **RUN_K)
    assert len(hist.finalize()["train"]["radius_error"]) == 10
    want = StageStore(str(tmp_path / "straight")).load_stage("location_joint")
    step = Trainer.step
    for at in (2, 7):
        calls = [0]

        def stepping(self, *a, **k):
            calls[0] += 1
            if calls[0] == at:
                self.request_preemption()
            return step(self, *a, **k)

        store = tmp_path / f"preempted_{at}"
        monkeypatch.setattr(Trainer, "step", stepping)
        with pytest.raises(Preempted):
            _recipe(store, val_set, composite, bank, **RUN_K)
        monkeypatch.setattr(Trainer, "step", step)
        tags = StageStore(str(store)).stages()
        assert f"location_joint_{at}" in tags and "location_joint" not in tags
        assert ("location_joint_4" in tags) == (at > 4)
        resumed, _ = _recipe(store, val_set, composite, bank, resume=True, **RUN_K)
        assert resumed.step_count == 10
        assert_bitwise(StageStore(str(store)).load_stage("location_joint"), want, f"final after a stop at {at}")


def test_cli_recipe_flags_and_resume(tmp_path, capsys):
    """The CLI's recipe flags: its errors (JAX's words), then ``--on-the-fly
    --joint-location --bank-pretrain-updates`` end to end at the smoke size
    with no training set made, and ``--resume`` skipping every stage."""
    base = ["--smoke", "--device", "cpu", "--width-scale", "0.0625", "--updates", "2", "--val-size", "4", "--seed",
            "3", "--store-dir", str(tmp_path / "store")]
    with pytest.raises(SystemExit, match="needs --joint-location"):
        cli_pipeline.main(base + ["--bank-pretrain-updates", "1"])
    with pytest.raises(SystemExit, match="requires --on-the-fly --rir-bank"):
        cli_pipeline.main(base + ["--joint-location", "--bank-pretrain-updates", "1", "--val-size", "0",
                                  "--dataset-size", "2"])
    argv = base + ["--on-the-fly", "--joint-location", "--predict-radius", "--rt60-range", "0.12", "0.75",
                   "--radius-range", "0.45", "1.45", "--snr-range", "0", "30", "--snr-clean-prob", "0.25",
                   "--rir-bank", "8", "--rir-bank-rt60s", "2", "--rir-bank-radii", "2",
                   "--bank-pretrain-updates", "1", "--polish-bank-prob", "0.25"]
    args = cli_pipeline.build_parser().parse_args(argv)
    _, train, val = cli_pipeline.load_datasets(args)
    assert train is None and set(val.radius.tolist()) <= set(np.linspace(0.45, 1.45, 2).astype(np.float32).tolist())
    assert set(args.synth_kwargs) == {"rir_bank", "rir_bank_radii", "snr_range", "snr_clean_prob"}
    assert args.synth_kwargs["rir_bank"].shape == (2, 2, 8, 512)
    assert cli_pipeline.recipe_kwargs(args)["joint_exact_synth_kwargs"] == {
        "rt60_range": (0.12, 0.75), "radius_range": (0.45, 1.45), "snr_range": (0.0, 30.0), "snr_clean_prob": 0.25}
    capsys.readouterr()
    cli_pipeline.main(argv)
    out = capsys.readouterr().out
    assert "building RIR bank: 8 angles x 2 T60s x 2 radii" in out and "joint location evaluation" in out
    assert "bank pretraining done at step 1" in out
    manifest = json.load(open(tmp_path / "store" / "manifest.json"))
    assert manifest["location_joint"]["step"] == 2 and "location_joint_1" in manifest
    cli_pipeline.main(argv + ["--resume"])
    again = capsys.readouterr().out
    for stage in ("speech", "rir", "echoed", "finetune", "location", "location_joint"):
        assert f"[pipeline] stage '{stage}' complete in store — skipping" in again, stage
