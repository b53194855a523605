"""The port's DSP against the JAX package's on the same numpy inputs: the FFT
convolution and the high-pass (``dsp/filters.py``), the STFT frontend and its
inverse (``dsp/stft.py``), the spectral ratio and the Wiener estimate
(``dsp/specs.py``), and the image-source RIR (``dsp/rir.py``), which is also
held against the C++ oracle ``native/ism.py``.

Geometry is cut to 512-tap RIRs and a 64-point STFT except in one full-size
RIR. Float32 sums run in another order in XLA-CPU and torch-CPU (and the
RIR's powers and exponentials round differently), so floats agree within the
tolerance each assert states, relative to the largest magnitude."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import dsp as jdsp
from acoustic_locating_vq_vae_tpu import native
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data.synth import geometry_boxes as jax_geometry_boxes
from acoustic_locating_vq_vae_tpu.dsp import rir as jrir
from acoustic_locating_vq_vae_torch import dsp
from acoustic_locating_vq_vae_torch.dsp import rir as trir

ROOM = (4.0, 5.0, 3.0)
RECEIVER = np.array([2.5, 1.5, 1.5], np.float32)
SOURCE = np.array([3.2, 2.1, 1.0], np.float32)
FS = 16000.0
NSAMPLE = 512
BETA = 0.7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU ops run faster on one thread, alone and beside the
    suite's other workers; the setting comes back after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def np_(a) -> np.ndarray:
    return np.array(a)  # a writable copy (torch.from_numpy of a JAX view warns)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np_(a))


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got, np.complex128) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------- filters


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fft_convolve_matches_jax(mode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    h = rng.standard_normal((3, 77)).astype(np.float32)
    want = jdsp.fft_convolve(jnp.asarray(x), jnp.asarray(h), mode=mode)
    got = dsp.fft_convolve(t_(x), t_(h), mode)
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-6
    # one kernel broadcast over the batch, and scipy's output selection
    from scipy.signal import convolve

    got1 = dsp.fft_convolve(t_(x), t_(h[0]), mode).numpy()
    np.testing.assert_allclose(got1[1], convolve(x[1], h[0], mode), atol=1e-5 * np.abs(got1).max())


def test_fft_convolve_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        dsp.fft_convolve(torch.ones(4), torch.ones(2), "circular")


def test_highpass_habets_matches_jax_and_the_recursion():
    """The closed-form AR response + FFT convolution equals JAX's in float32
    (XLA and torch round exp/sin differently: 1e-5 of the max) and, in
    float64, the Habets C++ loop's two-stage recursion."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    want = jdsp.highpass_habets(jnp.asarray(x), 16000)
    got = dsp.highpass_habets(t_(x), 16000)
    assert got.dtype == torch.float32 and rel_err(got, want) < 1e-5

    w = 2 * math.pi * 100.0 / 16000
    r1, b1, b2, a1 = math.exp(-w), 2 * math.exp(-w) * math.cos(w), -math.exp(-2 * w), -(1 + math.exp(-w))
    y = np.zeros(3)
    ref = np.zeros(2048)
    for n, x0 in enumerate(x[0].astype(np.float64)):
        y[2], y[1] = y[1], y[0]
        y[0] = b1 * y[1] + b2 * y[2] + x0
        ref[n] = y[0] + a1 * y[1] + r1 * y[2]
    got64 = dsp.highpass_habets(t_(x[0]).double(), 16000)
    assert got64.dtype == torch.float64 and rel_err(got64, ref) < 1e-9


# ---------------------------------------------------------------- STFT


@pytest.mark.parametrize("normalized", [True, False, "window", "frame_length"])
def test_stft_matches_jax(normalized):
    wave = np.random.default_rng(3).standard_normal((2, 3, 3200)).astype(np.float32)
    want = jdsp.stft(jnp.asarray(wave), 64, 32, normalized=normalized)
    got = dsp.stft(t_(wave), 64, 32, normalized=normalized)
    assert got.shape == want.shape == (2, 3, 33, 101)
    assert rel_err(got, want) < 1e-6


def test_spectrogram_normalization_is_torchaudio_window_mode():
    """``normalized=True`` divides by sqrt(sum(window**2)) (torchaudio's
    "window" mode, the JAX package's), not by sqrt(n_fft) as
    ``torch.stft(normalized=True)`` does: at n_fft = 400 that is a factor of
    2.67 in power, which this test would see."""
    wave = np.random.default_rng(4).standard_normal((2, 8000)).astype(np.float32)
    want = np.asarray(jdsp.spectrogram(jnp.asarray(wave), power=2.0))
    got = dsp.spectrogram(t_(wave), power=2.0).numpy()
    assert got.shape == (2, 201, 51) and rel_err(got, want) < 1e-5
    window = dsp.hann_window(400)
    torch_norm = torch.abs(torch.stft(t_(wave), 400, 160, window=window, normalized=True,
                                      return_complex=True)) ** 2
    ratio = float(torch_norm.sum() / got.sum())
    assert ratio == pytest.approx(float((window**2).sum()) / 400, rel=1e-4)
    assert abs(ratio - 1.0) > 0.5


def test_hann_window_matches_jax_and_torch():
    np.testing.assert_allclose(dsp.hann_window(400).numpy(), np.asarray(jdsp.hann_window(400)), atol=1e-7)
    np.testing.assert_allclose(dsp.hann_window(400).numpy(), torch.hann_window(400).numpy(), atol=1e-6)
    np.testing.assert_allclose(dsp.hann_window(9, periodic=False).numpy(),
                               np.asarray(jdsp.hann_window(9, periodic=False)), atol=1e-7)


def test_istft_round_trip_matches_jax():
    wave = np.random.default_rng(5).standard_normal((3, 3200)).astype(np.float32)
    spec = jdsp.spectrogram(jnp.asarray(wave), n_fft=64, hop_length=32)
    want = jdsp.inverse_spectrogram(spec, n_fft=64, hop_length=32, length=3200)
    got = dsp.inverse_spectrogram(t_(spec), n_fft=64, hop_length=32, length=3200)
    assert got.shape == (3, 3200)
    assert rel_err(got, want) < 1e-6
    np.testing.assert_allclose(got.numpy(), wave, atol=1e-5)
    # no length: the centered frames' span, as JAX
    got_n = dsp.istft(t_(spec), 64, 32, normalized=True)
    assert got_n.shape == jdsp.istft(spec, 64, 32, normalized=True).shape


def test_griffin_lim_matches_jax_from_its_initial_phase():
    """Four momentum iterations from JAX's own random initial phase."""
    wave = np.random.default_rng(6).standard_normal((2, 1600)).astype(np.float32)
    mag = jdsp.spectrogram(jnp.asarray(wave), n_fft=64, hop_length=32, power=2.0)
    key = jax.random.PRNGKey(7)
    want = jdsp.griffin_lim(mag, key, n_fft=64, hop_length=32, n_iter=4, length=1600)
    angle = jax.random.uniform(key, mag.shape, minval=0.0, maxval=2.0 * jnp.pi)
    got = dsp.griffin_lim_from_angle(t_(mag), t_(angle), n_fft=64, hop_length=32, n_iter=4, length=1600)
    assert got.shape == (2, 1600) and rel_err(got, want) < 1e-4
    drawn = dsp.griffin_lim(t_(mag), torch.Generator().manual_seed(0), n_fft=64, hop_length=32, n_iter=2)
    assert drawn.shape == (2, 1600) and bool(torch.isfinite(drawn).all())


def test_power_to_db_matches_jax():
    s = np.random.default_rng(8).exponential(size=(3, 33, 20)).astype(np.float32) ** 4
    np.testing.assert_allclose(dsp.power_to_db(t_(s)).numpy(), np.asarray(jdsp.power_to_db(jnp.asarray(s))),
                               atol=1e-4)
    np.testing.assert_allclose(dsp.power_to_db(t_(s), ref=2.0, top_db=None).numpy(),
                               np.asarray(jdsp.power_to_db(jnp.asarray(s), ref=2.0, top_db=None)), atol=1e-4)


# ---------------------------------------------------------------- spectral features


def _complex_pair(seed, b=3, f=33, t=40):
    rng = np.random.default_rng(seed)
    c = lambda: (rng.standard_normal((b, f, t)) + 1j * rng.standard_normal((b, f, t))).astype(np.complex64)
    speech, echoed = c(), c()
    speech *= np.asarray([1.0, 30.0, 0.02], np.float32)[:, None, None][:b]  # per-sample maxima differ
    return speech, echoed


def test_rir_spec_ratio_normalizes_each_sample():
    """The max-normalization is per sample over (F, T), as JAX's ``vmap``
    over samples (``synth.py:646``), not over the batch."""
    speech, echoed = _complex_pair(9)
    want = jax.vmap(jdsp.rir_spec_ratio)(jnp.asarray(speech), jnp.asarray(echoed))
    got = dsp.rir_spec_ratio(t_(speech), t_(echoed))
    assert rel_err(got, want) < 1e-6
    np.testing.assert_allclose(torch.abs(got).amax(dim=(1, 2)).numpy(), 1.0, rtol=1e-6)
    batch_wide = np.asarray(jdsp.rir_spec_ratio(jnp.asarray(speech), jnp.asarray(echoed)))
    assert np.abs(np.abs(batch_wide).max(axis=(1, 2)) - 1.0).max() > 0.5
    # one sample alone is normalized as in the batch
    np.testing.assert_allclose(dsp.rir_spec_ratio(t_(speech[1]), t_(echoed[1])).numpy(), got[1].numpy(), rtol=1e-6)


def test_wiener_estimate_matches_jax():
    speech, echoed = _complex_pair(10)
    want = jdsp.wiener_estimate(jnp.asarray(speech), jnp.asarray(echoed))
    got = dsp.wiener_estimate(t_(speech), t_(echoed))
    assert got.shape == (3, 33) and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5


# ---------------------------------------------------------------- image-source RIR


@pytest.mark.parametrize("case", ["culled", "unculled", "boxed"])
def test_image_grid_bounds_equal_jax(case):
    kw = dict(cull=case != "unculled")
    if case == "boxed":
        kw.update(zip(("source_box", "receiver_box"), jax_geometry_boxes(JaxDatasetConfig(), 1.2)))
    want = jrir._image_grid_bounds(ROOM, 1024, FS, 340.0, **kw)
    got = trir._image_grid_bounds(ROOM, 1024, FS, 340.0, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "boxed":
        assert got[0].shape[0] < trir._image_grid_bounds(ROOM, 1024, FS, 340.0)[0].shape[0]


@pytest.mark.parametrize("method,hp", [("block_matmul", False), ("block_matmul", True), ("scatter", True)])
def test_generate_rir_matches_jax(method, hp):
    """Both accumulations against JAX's, within 1e-5 of the max (float32
    products and powers round differently)."""
    kw = dict(room=ROOM, nsample=NSAMPLE, fs=FS, beta=BETA, hp=hp, chunk=256, method=method)
    want = jdsp.generate_rir(jnp.asarray(SOURCE), jnp.asarray(RECEIVER), **kw)
    got = dsp.generate_rir(t_(SOURCE), t_(RECEIVER), **kw)
    assert got.shape == (NSAMPLE,) and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5


def test_generate_rir_matches_the_native_oracle():
    """The C++ oracle (``native/ism.py``, the Habets loop in float64), under
    the tolerance ``tests/test_dsp_rir.py`` holds JAX to (atol 5e-4 of the
    max, rtol 1e-2); the port in float64 to 1e-9 of the max."""
    if not native.is_available():
        pytest.skip("no C++ toolchain for the native ISM library")
    cpp = native.generate_rir_native(SOURCE.astype(np.float64), RECEIVER, ROOM, NSAMPLE, FS, beta=BETA, hp=True)
    got = dsp.generate_rir(t_(SOURCE), t_(RECEIVER), room=ROOM, nsample=NSAMPLE, fs=FS, beta=BETA, chunk=256)
    np.testing.assert_allclose(got.numpy(), cpp, atol=5e-4 * np.abs(cpp).max(), rtol=1e-2)
    got64 = dsp.generate_rir(t_(SOURCE).double(), t_(RECEIVER), room=ROOM, nsample=NSAMPLE, fs=FS, beta=BETA,
                             chunk=256)
    assert got64.dtype == torch.float64 and rel_err(got64, cpp) < 1e-9


def test_beta_from_rt60_traced_matches_jax():
    rt60 = np.asarray([0.2, 0.4, 0.61, 0.05], np.float32)  # the last is outside Sabine's range: 0
    want = jdsp.beta_from_rt60_traced(ROOM, jnp.asarray(rt60))
    got = dsp.beta_from_rt60_traced(ROOM, t_(rt60))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[-1]) == 0.0
    assert float(got[1]) == pytest.approx(dsp.beta_from_rt60(ROOM, 0.4), rel=1e-6)
    with pytest.raises(ValueError, match="too small"):
        dsp.beta_from_rt60(ROOM, 0.05)


def test_per_sample_rt60_batch_matches_jax_and_single_rows():
    """``rt60_traced`` gives each source its own beta: the batch equals JAX's
    vmap (within 5e-5 of the max, float32 powers of six T60s' betas) and,
    row by row, a batch of one at that row's static T60."""
    rng = np.random.default_rng(11)
    theta = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)  # six sources: not six walls
    sources = np.stack([RECEIVER[0] + np.cos(theta), RECEIVER[1] + np.sin(theta), np.full(6, 1.0)], 1)
    sources = sources.astype(np.float32)
    rt60 = np.asarray([0.25, 0.4, 0.7, 0.3, 0.55, 0.9], np.float32)
    kw = dict(room=ROOM, nsample=NSAMPLE, fs=FS, chunk=512)
    want = jdsp.generate_rir_batch(jnp.asarray(sources), jnp.asarray(RECEIVER), jnp.asarray(rt60), **kw)
    got = dsp.generate_rir_batch(t_(sources), t_(RECEIVER), t_(rt60), **kw)
    assert got.shape == (6, NSAMPLE) and rel_err(got, want) < 5e-5  # read 1.2e-5
    for i in range(6):
        row = dsp.generate_rir_batch(t_(sources[i : i + 1]), t_(RECEIVER), rt60=float(rt60[i]), **kw)
        np.testing.assert_allclose(row[0].numpy(), got[i].numpy(), atol=1e-5 * float(got[i].abs().max()))
    with pytest.raises(ValueError, match="excludes"):
        dsp.generate_rir_batch(t_(sources), t_(RECEIVER), t_(rt60), rt60=0.4, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        dsp.generate_rir_batch(t_(sources), t_(RECEIVER), **kw)
    with pytest.raises(ValueError, match=r"\(6,\)"):
        dsp.generate_rir_batch(t_(sources), t_(RECEIVER), t_(rt60[:3]), **kw)


def test_full_geometry_boxed_rir_matches_jax():
    """The dataset's full geometry (6400 taps, the geometry-boxed cull of
    radius 1 m, chunks of 8192 images), two sources: the block matmul
    against JAX's, and the float64 path against the float32 one, within 1e-4
    of the max. Over 179,443 images float32 rounding reaches 1.3e-5 to
    2.2e-5 of the max, JAX's own as the port's, from the port in float64 (at
    three pairs of angles); the range reduction keeps the taps exact at
    distances of thousands of samples."""
    cfg = JaxDatasetConfig()
    sbox, rbox = jax_geometry_boxes(cfg, cfg.R)
    theta = np.asarray([0.3, -2.2], np.float32)
    rec = np.asarray(cfg.receiver_position, np.float32)
    sources = np.stack([rec[0] + np.cos(theta), rec[1] + np.sin(theta), np.full(2, min(rec[2] + 1.0, 3.0))], 1)
    sources = np.minimum(sources, np.asarray(cfg.room_dimensions, np.float32)).astype(np.float32)
    kw = dict(room=cfg.room_dimensions, nsample=cfg.n_sample, fs=float(cfg.fs), rt60=cfg.reverberation_time,
              chunk=8192, source_box=sbox, receiver_box=rbox)
    want = jdsp.generate_rir_batch(jnp.asarray(sources), jnp.asarray(rec), **kw)
    got = dsp.generate_rir_batch(t_(sources), t_(rec), **kw)
    assert got.shape == (2, 6400) and rel_err(got, want) < 1e-4
    got64 = dsp.generate_rir_batch(t_(sources).double(), t_(rec), **kw)
    assert rel_err(got, got64) < 1e-4
    assert trir._chunked_lattice(tuple(cfg.room_dimensions), 6400, 16000.0, 340.0, True, sbox, rbox, 8192)[0].shape \
        == (22, 8192, 6)


def test_rir_options_and_refusals():
    kw = dict(room=ROOM, nsample=NSAMPLE, fs=FS, chunk=256)
    src, rec = t_(SOURCE), t_(RECEIVER)
    six = dsp.generate_rir(src, rec, beta=(BETA,) * 6, **kw)
    np.testing.assert_array_equal(six.numpy(), dsp.generate_rir(src, rec, beta=BETA, **kw).numpy())
    traced = dsp.generate_rir(src, rec, beta_traced=torch.tensor(BETA), **kw)
    np.testing.assert_array_equal(traced.numpy(), six.numpy())
    want = jdsp.generate_rir(jnp.asarray(SOURCE), jnp.asarray(RECEIVER), beta=BETA, order=2, **kw)
    assert rel_err(dsp.generate_rir(src, rec, beta=BETA, order=2, **kw), want) < 1e-5
    with pytest.raises(ValueError, match="even tw"):
        dsp.generate_rir(src, rec, beta=BETA, tw=127, **kw)
    with pytest.raises(ValueError, match="CPU cross-check"):
        dsp.generate_rir_batch(torch.zeros(1, 3, device="meta"), rec, beta=BETA, method="scatter", **kw)
    with pytest.raises(ValueError, match="unknown method"):
        dsp.generate_rir(src, rec, beta=BETA, method="loop", **kw)


# ---------------------------------------------------------------- the tap kernel's static plan

CELL = JaxDatasetConfig()  # the on-the-fly cell's geometry: 4 x 5 x 3 m, 6,400 taps, 16 kHz
PLAN_CASES = {
    # (room, nsample, cull, boxed, order, seg)
    "cell_boxed": (tuple(CELL.room_dimensions), CELL.n_sample, True, True, -1, 256),
    "cell_room": (tuple(CELL.room_dimensions), CELL.n_sample, True, False, -1, 256),
    "small_unculled_order2": ((2.0, 2.5, 1.8), 1024, False, False, 2, 64),
}


def _plan_positions(case, room, boxed, rng):
    """Sources and receivers in meters that the plan's intervals allow: the
    box's corners and draws inside it (the boxed cell: the 1 m source circle
    at its fixed height, the fixed receiver), else the room's."""
    if boxed:
        (slo, shi), (rlo, rhi) = (np.asarray(box, np.float64) for box in jax_geometry_boxes(CELL, CELL.R))
    else:
        slo = rlo = np.zeros(3)
        shi = rhi = np.asarray(room, np.float64)
    corners = np.unique(np.stack(np.meshgrid(*zip(slo, shi), indexing="ij"), -1).reshape(-1, 3), axis=0)
    src = np.concatenate([corners, rng.uniform(slo, shi, (2, 3))])
    rec = np.concatenate([[rlo, rhi], rng.uniform(rlo, rhi, (len(src) - 2, 3))])
    return src, rec


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_tap_plan_lists_every_reachable_row(case):
    """By brute force over the whole lattice in float64: every (row,
    segment) pair whose taps a position inside the cull's intervals puts in
    that segment is in the segment's list, no list holds a row twice, and no
    row beyond ``order`` is listed."""
    room, nsample, cull, boxed, order, seg = PLAN_CASES[case]
    boxes = dict(zip(("source_box", "receiver_box"), jax_geometry_boxes(CELL, CELL.R))) if boxed else {}
    entries, slot_ptr, slot_seg, rows, max_pow = trir._tap_plan(
        room, nsample, FS, 340.0, cull, boxes.get("source_box"), boxes.get("receiver_box"), order, 128, seg)
    n_seg = -(-nsample // seg)
    assert slot_ptr[0] == 0 and slot_ptr[-1] == entries.shape[0] and np.all(np.diff(slot_ptr) >= 0)
    assert sorted(slot_seg.tolist()) == list(range(n_seg))
    lens = np.diff(slot_ptr)
    assert np.all(lens[:-1] >= lens[1:])  # the longest list first
    seg_of = np.repeat(slot_seg, lens).astype(np.int64)
    key = lambda m, qbits: (((m[:, 0] + 64) * 128 + m[:, 1] + 64) * 128 + m[:, 2] + 64) * 8 + qbits  # noqa: E731
    listed = seg_of * 2**24 + key(entries[:, :3].astype(np.int64), entries[:, 3].astype(np.int64))
    listed = np.sort(listed)
    assert np.all(listed[1:] > listed[:-1])
    assert np.unique(key(entries[:, :3].astype(np.int64), entries[:, 3].astype(np.int64))).size == rows
    assert max_pow == np.abs(entries[:, :3]).max() + 1

    lattice = trir._image_grid_bounds(room, nsample, FS, 340.0, cull=False)[0].astype(np.int64)
    m, q = lattice[:, :3], lattice[:, 3:]
    refl = np.abs(2 * m - q).sum(1)
    if order >= 0:
        assert np.abs(2 * entries[:, :3] - ((entries[:, 3:] >> np.arange(3)) & 1)).sum(1).max() <= order
        assert (refl > order).any()  # the case does exclude rows
    cTs, half = 340.0 / FS, 64
    L = np.asarray(room) / cTs
    src, rec = _plan_positions(case, room, boxed, np.random.default_rng(3))
    s, r = src / cTs, rec / cTs  # (positions, 3)
    d = np.sqrt(sum(((1 - 2 * q[:, a]) * s[:, a, None] - r[:, a, None] + 2 * m[:, a] * L[a]) ** 2 for a in range(3)))
    fd = np.floor(d).astype(np.int64)  # (positions, rows)
    hit = (fd < nsample) & ((refl <= order) if order >= 0 else True)
    # d is continuous over the box, so a row reaches every segment between the least and the greatest it reaches
    first = np.where(hit, np.maximum(fd - half + 1, 0) // seg, n_seg).min(0)
    last = np.where(hit, np.minimum(fd + half, nsample - 1) // seg, -1).max(0)
    reached = last >= 0
    first, last = first[reached], last[reached]
    k = key(m[reached], q[reached, 0] | (q[reached, 1] << 1) | (q[reached, 2] << 2))
    reach = last - first + 1
    row = np.repeat(np.arange(k.size), reach)
    segment = np.repeat(first, reach) + np.arange(row.size) - np.repeat(np.cumsum(reach) - reach, reach)
    need = segment * 2**24 + k[row]
    found = listed[np.minimum(np.searchsorted(listed, need), listed.size - 1)] == need
    assert found.all(), f"{int((~found).sum())} reachable pairs not listed"


def _kernel_in_numpy(sources, receiver, betas, room, nsample, plan, seg, tw=128, c=340.0):
    """The tap kernel's arithmetic (``csrc/rir_taps.cu``) over its plan in
    float64 numpy: each segment's listed rows, the window-local hoisted taps
    with an even origin, each output sample summed in list order."""
    entries, slot_ptr, slot_seg, _, _ = plan
    cts, half = c / FS, tw // 2
    s, r, L = sources / cts, receiver / cts, np.asarray(room) / cts
    n_tab = np.arange(tw + 1)
    out = np.zeros((sources.shape[0], nsample))
    for k, segment in enumerate(slot_seg):
        e = entries[slot_ptr[k] : slot_ptr[k + 1]].astype(np.int64)
        p = segment * seg + np.arange(seg)
        p = p[p < nsample]
        m, q = e[:, :3], (e[:, 3:] >> np.arange(3)) & 1
        pos = np.where(q[None] == 1, -s[:, None], s[:, None]) - r + 2 * m * L  # (B, R, 3)
        d = np.sqrt((pos**2).sum(-1))
        expo = np.stack([np.abs(m[:, 0] - q[:, 0]), np.abs(m[:, 0]), np.abs(m[:, 1] - q[:, 1]), np.abs(m[:, 1]),
                         np.abs(m[:, 2] - q[:, 2]), np.abs(m[:, 2])], 1)
        gain = np.prod(betas[:, None, :] ** expo[None], -1) / (4 * np.pi * np.maximum(d, 1e-8) * cts)
        fd = np.floor(d)
        start = fd.astype(np.int64) - half + 1
        k0 = start & ~1
        ce, se = np.cos(2 * np.pi * (d - k0) / tw), np.sin(2 * np.pi * (d - k0) / tw)
        spe = np.where(fd.astype(np.int64) & 1, -1.0, 1.0) * np.sin(np.pi * (d - fd))
        n = p - k0[..., None]  # (B, R, P)
        active = (fd < nsample)[..., None] & (p >= start[..., None]) & (p < start[..., None] + tw)
        n = np.clip(n, 0, tw)
        t = p - d[..., None]
        window = 0.5 * (1 + np.cos(2 * np.pi * n_tab / tw)[n] * ce[..., None] + np.sin(2 * np.pi * n_tab / tw)[n]
                        * se[..., None])
        sin_pt = np.where(n & 1, 1.0, -1.0) * spe[..., None]
        with np.errstate(divide="ignore", invalid="ignore"):
            sinc = np.where(t == 0, 1.0, sin_pt / (np.pi * t + 1e-30))
        out[:, p] = np.where(active, gain[..., None] * window * sinc, 0.0).sum(1)
    return out


@pytest.mark.parametrize("opts", ["rt60", "rt60_traced", "order2_unculled", "six_betas"])
def test_tap_plan_and_kernel_arithmetic_match_the_plain_version(opts):
    """The kernel's plan and arithmetic, run in float64 numpy, give the plain
    version's float64 RIRs (before the high-pass) to 1e-12 of the max, for
    sources anywhere in a small room, each option the card takes."""
    room, nsample = (3.0, 3.5, 2.5), 1024
    rng = np.random.default_rng(8)
    sources = rng.uniform(0.0, 1.0, (3, 3)) * np.asarray(room)
    receiver = np.asarray([1.1, 2.0, 1.3])
    kw = dict(room=room, nsample=nsample, fs=FS, hp=False, chunk=512)
    order, cull = (2, False) if opts == "order2_unculled" else (-1, True)
    if opts == "rt60_traced":
        rt60 = np.asarray([0.2, 0.45, 0.8])
        betas = np.asarray([[trir.beta_from_rt60(room, t)] * 6 for t in rt60])
        want = dsp.generate_rir_batch(t_(sources), t_(receiver), t_(rt60), **kw)
    else:
        six = (0.9, 0.5, 0.7, 0.8, 0.6, 0.75) if opts == "six_betas" else (trir.beta_from_rt60(room, 0.4),) * 6
        betas = np.tile(six, (3, 1))
        extra = dict(beta=six) if opts == "six_betas" else dict(rt60=0.4)
        want = dsp.generate_rir_batch(t_(sources), t_(receiver), order=order, cull=cull, **extra, **kw)
    plan = trir._tap_plan(room, nsample, FS, 340.0, cull, None, None, order, 128, 64)
    got = _kernel_in_numpy(sources, receiver, betas, room, nsample, plan, 64)
    assert want.dtype == torch.float64 and rel_err(got, want) < 1e-12
