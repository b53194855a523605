"""The sample batch, and its synthesis on the device.

Counterpart of ``acoustic_locating_vq_vae_tpu/data/synth.py:53-131`` and
``:254-757``, which replace the reference's serial CPU generator
(scripts/genereate_dataset.py:54-103: per sample a C++ RIR, a scipy
convolution and two STFTs) by one batch program on the device. Per sample
(genereate_dataset.py:12-51):

    theta ~ U(-pi, pi);  source = receiver + (R cos, R sin, Z), clipped to the room
    h = ISM(...);  echoed = convolve(speech, h, 'same')
    speech_spec, echoed_spec = STFT(speech), STFT(echoed)    [complex, normalized]
    rir_spec   = speech_spec / (echoed_spec + 1e-8), max-normalized per sample
    wiener_est = |sum_t(echoed conj(speech)) / sum_t |speech|^2|^2
    the spectrograms -> power (|.|^2), truncated to num_frames

:func:`synthesize_batch` is a draw step (:func:`draw_synthesis`, every random
value from one ``torch.Generator``) and a deterministic core
(:func:`synthesize_from_draws`), so the same draws give the same batch on the
card and, in float64, on the CPU. The generator's streams are consumed in a
fixed order whatever the options, so an option changes no other draw, and
giving the geometry a random run drew reproduces that run.

The RIR bank (``:134-244``): :func:`make_rir_bank` precomputes the RIRs of a
grid of angles (:func:`bank_thetas`), optionally times a T60 grid and a
radius grid, and synthesis can gather each sample's RIR from it in place of
the image-source sum (``rir_bank``, ``rir_bank_radii``), or mix the two per
sample (``bank_mix_prob``). Host-staged datasets are ``data/dataset.py``'s.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..dsp.filters import fft_convolve
from ..dsp.rir import generate_rir_batch
from ..dsp.specs import rir_spec_ratio, source_coordinates, wiener_estimate
from ..dsp.stft import spectrogram
from ..utils.device import resolve_device, static_tensor
from ..utils.profiling import span
from .config import DatasetConfig
from .speech import speech_draws, speech_from_draws

__all__ = [
    "SampleBatch",
    "SynthDraws",
    "add_sensor_noise",
    "bank_thetas",
    "dataset_batches",
    "draw_synthesis",
    "echoed_from_draws",
    "geometry_boxes",
    "make_dataset",
    "make_rir_bank",
    "max_source_radius",
    "observed_power_spec",
    "prune_batch",
    "rirs_from_draws",
    "synthesize_batch",
    "synthesize_from_draws",
]

SPEC_FIELDS = ("speech_spec", "rir_spec", "echoed_spec", "wiener_est")


class SampleBatch(NamedTuple):
    """The reference 6-tuple (specsdataset.py:31-36) plus the per-sample
    source radius, as tensors: power spectrograms truncated to the fixed
    500-frame geometry."""

    speech_spec: torch.Tensor  # (B, F, T)
    rir_spec: torch.Tensor  # (B, F, T)
    echoed_spec: torch.Tensor  # (B, F, T)
    fs: torch.Tensor  # (B,)
    theta: torch.Tensor  # (B,)
    wiener_est: torch.Tensor  # (B, F)
    radius: torch.Tensor  # (B,)

    def as_tuple(self):
        return (self.speech_spec, self.rir_spec, self.echoed_spec, self.fs, self.theta, self.wiener_est)

    def map(self, fn) -> "SampleBatch":
        """A batch of ``fn`` applied to every field."""
        return SampleBatch(*(fn(t) for t in self))


def _complex_spectrogram(wave: torch.Tensor, config: DatasetConfig) -> torch.Tensor:
    """The pipeline's normalized complex STFT (genereate_dataset.py:90-91)."""
    return spectrogram(wave, n_fft=config.NFFT, hop_length=config.HOP_LENGTH, power=None, normalized=True)


def _power_truncated(spec: torch.Tensor, config: DatasetConfig) -> torch.Tensor:
    """Complex spectrogram -> power, truncated to the fixed frame count."""
    return (torch.abs(spec) ** 2)[..., : config.num_frames]


def observed_power_spec(wave: torch.Tensor, config: DatasetConfig) -> torch.Tensor:
    """Waveform -> the power spectrogram the models read: the frontend that
    :func:`synthesize_from_draws` builds its spectrogram fields from."""
    return _power_truncated(_complex_spectrogram(wave, config), config)


def max_source_radius(config: DatasetConfig) -> float:
    """Largest source-circle radius that stays inside the room around the
    receiver's xy position. ``source_coordinates`` clips only at the upper
    walls (reference quirk, genereate_dataset.py:18-19), so a larger radius
    would place sources outside the room and break the image-source geometry
    and its static cull."""
    rx, ry = config.receiver_position[0], config.receiver_position[1]
    lx, ly = config.room_dimensions[0], config.room_dimensions[1]
    return float(min(rx, lx - rx, ry, ly - ry))


def geometry_boxes(config: DatasetConfig, r_hi: float):
    """Static ``(source_box, receiver_box)`` of the task's geometry: a fixed
    receiver and sources on circles of radius <= ``r_hi`` at a fixed height,
    upper-wall clipped as ``source_coordinates`` does. They bound every
    position synthesis can draw, so the RIR's tighter cull stays exact."""
    rx, ry, rz = (float(v) for v in config.receiver_position)
    lx, ly, lz = (float(v) for v in config.room_dimensions)
    r_hi = float(r_hi)
    sz = min(rz + float(config.Z_LOC_SOURCE), lz)  # fixed source height
    source_box = (
        (min(rx - r_hi, lx), min(ry - r_hi, ly), sz),
        (min(rx + r_hi, lx), min(ry + r_hi, ly), sz),
    )
    receiver_box = ((rx, ry, rz), (rx, ry, rz))
    return source_box, receiver_box


def bank_thetas(n_theta: int) -> np.ndarray:
    """The angle grid a RIR bank is built on: the bin centers of a uniform
    ``n_theta``-partition of (-pi, pi], in float32."""
    return (-np.pi + (np.arange(n_theta) + 0.5) * (2.0 * np.pi / n_theta)).astype(np.float32)


def make_rir_bank(
    config: DatasetConfig = DatasetConfig(),
    n_theta: int = 4096,
    rt60s: Optional[Sequence[float]] = None,
    radii: Optional[Sequence[float]] = None,
    chunk: int = 8192,
    batch: int = 256,
    device="cuda",
) -> torch.Tensor:
    """The RIR bank that synthesis can draw from, in float32 on ``device``
    (default the card; raises without one unless asked for ``"cpu"``).

    The source lies on a circle around the fixed receiver, so the RIRs of
    ``n_theta`` grid angles (:func:`bank_thetas`), times a grid of T60s
    (``rt60s``) and of source radii (``radii``) where given, cover the
    geometry; a synthesized sample then gathers its RIR in place of the
    image-source sum. Each grid cell is made by ``generate_rir_batch``,
    ``batch`` angles at a time, with the cull boxed at that cell's radius,
    so the bank is deterministic (no ``index_add_``). At the reference
    geometry a RIR is 25.6 KB: 1024 angles x 8 T60s x 8 radii is 1.68 GB.

    Returns (n_theta, n_sample); ``rt60s`` prepends a T60 axis, (n_t60,
    n_theta, n_sample). ``radii`` always gives the 4-D (n_t60, n_r, n_theta,
    n_sample), n_t60 = 1 without ``rt60s``: a 3-D radius bank could not be
    told from a T60 bank by its shape, and synthesis refuses a 4-D bank
    without its ``rir_bank_radii``. Every radius must keep the source circle
    inside the room; a radius grid coarser than 5 cm warns."""
    device = resolve_device(device)
    if radii is not None:
        radii = [float(r) for r in radii]
        max_r = max_source_radius(config)
        bad = [r for r in radii if not 0.0 < r < max_r]
        if bad:
            raise ValueError(
                f"bank radii {bad} outside (0, {max_r}) (receiver {config.receiver_position[:2]} in room "
                f"{config.room_dimensions[:2]}): sources would leave the room")
        if len(radii) > 1:
            gap = max(b - a for a, b in zip(sorted(radii), sorted(radii)[1:]))
            if gap > 0.05:
                warnings.warn(
                    f"RIR-bank radius grid spacing {gap * 100:.1f} cm: a model trained only on this bank can fail "
                    "to generalize to OFF-grid radii in the near field (VALIDATION.md run G: 14.3 cm spacing "
                    "localized at median 0.023 rad ON the grid but 0.090 rad just 3.6 cm off it at R=0.7). Keep "
                    "adjacent radii within ~5 cm, or finish with an exact-synthesis leg (drop rir_bank, keep "
                    "radius_range).", stacklevel=2)
    t60_grid = [config.reverberation_time] if rt60s is None else [float(t) for t in rt60s]
    r_grid = [float(config.R)] if radii is None else radii
    thetas = torch.from_numpy(bank_thetas(n_theta)).to(device)
    receiver = torch.tensor(config.receiver_position, dtype=torch.float32).to(device)
    room = torch.tensor(config.room_dimensions, dtype=torch.float32).to(device)
    kw = dict(room=tuple(config.room_dimensions), nsample=config.n_sample, fs=float(config.fs), c=config.c, chunk=chunk)
    bank = torch.empty((len(t60_grid), len(r_grid), n_theta, config.n_sample), device=device)
    for j, r in enumerate(r_grid):
        src = source_coordinates(thetas, receiver, room, radius=r, z_loc=config.Z_LOC_SOURCE)
        sbox, rbox = geometry_boxes(config, r)  # the cell's geometry is static: box the cull at this radius
        for i, t60 in enumerate(t60_grid):
            for k in range(0, n_theta, batch):
                bank[i, j, k : k + batch] = generate_rir_batch(
                    src[k : k + batch], receiver, rt60=t60, source_box=sbox, receiver_box=rbox, **kw)
    if radii is not None:
        return bank
    return bank[:, 0] if rt60s is not None else bank[0, 0]


def _bank_view(rir_bank: torch.Tensor) -> torch.Tensor:
    """Any bank layout as its 4-D (n_t60, n_r, n_theta, n_sample) view."""
    return {2: lambda b: b[None, None], 3: lambda b: b[:, None], 4: lambda b: b}[rir_bank.dim()](rir_bank)


class SynthDraws(NamedTuple):
    """Every random input of a synthesized batch of B samples."""

    theta: torch.Tensor  # (B,) rad
    radius: torch.Tensor  # (B,) m
    speech: torch.Tensor  # (B, audio_samples)
    rt60: Optional[torch.Tensor]  # (B,) s, or None: the config's T60
    snr_db: Optional[torch.Tensor]  # (B,), or None: no sensor noise
    noise: Optional[torch.Tensor]  # (B, audio_samples) standard normal, with snr_db
    clean: Optional[torch.Tensor]  # (B,) bool, samples left without noise, or None
    r_hi: float  # static bound of the radius, for the geometry-boxed cull
    # (B, 3) int64 (T60, radius, angle) cells of the bank's 4-D view that the samples gather, or None: no bank
    bank_index: Optional[torch.Tensor] = None
    # (B,) bool, the samples that gather from the bank (the others are synthesized exactly), or None: all do
    use_bank: Optional[torch.Tensor] = None

    def to(self, device=None, dtype=None) -> "SynthDraws":
        """The draws on ``device``, floating tensors cast to ``dtype``."""
        def move(a):
            if not isinstance(a, torch.Tensor):
                return a
            return a.to(device=device, dtype=dtype if dtype is not None and a.is_floating_point() else None)

        return SynthDraws(*(move(a) for a in self))


def _check_options(config, fixed_rir, rt60_range, radius_range, theta, radius, snr_range, snr_clean_prob,
                   rir_bank, rir_bank_radii, bank_mix_prob) -> None:
    """The option errors of the JAX ``synthesize_batch`` (``synth.py:367-472``), in its order and words."""
    if bank_mix_prob is not None:
        if rir_bank is None:
            raise ValueError("bank_mix_prob requires rir_bank")
        if not 0.0 < float(bank_mix_prob) < 1.0:
            raise ValueError(
                "bank_mix_prob must be strictly between 0 and 1 (use rir_bank=None for pure exact, no "
                f"bank_mix_prob for pure bank), got {bank_mix_prob}")
        if fixed_rir or theta is not None or radius is not None:
            raise ValueError("bank_mix_prob excludes fixed_rir and given theta/radius")
    if rir_bank is not None and rt60_range is not None and bank_mix_prob is None:
        raise ValueError("rir_bank excludes rt60_range: use a 3-D bank (make_rir_bank rt60s=...) for "
                         "reverberation randomization")
    if rir_bank is not None and radius_range is not None and bank_mix_prob is None:
        raise ValueError(
            "rir_bank excludes radius_range: the bank's RIRs are precomputed at fixed radii — use a "
            "radius-gridded bank (make_rir_bank radii=... + rir_bank_radii=) for geometry randomization from "
            "the bank")
    if theta is not None and rir_bank is not None:
        raise ValueError("given theta excludes rir_bank (bank RIRs exist only at grid angles): drop the bank to "
                         "synthesize the exact geometry")
    if radius is not None and radius_range is not None:
        raise ValueError("given radius excludes radius_range")
    if rir_bank_radii is not None:
        if rir_bank is None:
            raise ValueError("rir_bank_radii requires rir_bank")
        if radius is not None:
            raise ValueError("given radius excludes a radius-gridded rir_bank (bank RIRs exist only at grid "
                             "radii): drop the bank to synthesize the exact geometry")
        if rir_bank.dim() != 4:
            raise ValueError(
                "rir_bank_radii requires a 4-D (n_t60, n_r, n_theta, n_sample) bank — make_rir_bank(radii=...) "
                f"always returns one, with n_t60=1 when rt60s is None — got ndim {rir_bank.dim()}")
        if rir_bank.shape[1] != len(rir_bank_radii):
            raise ValueError(
                f"rir_bank radius axis {rir_bank.shape[1]} != len(rir_bank_radii) {len(rir_bank_radii)}")
    elif rir_bank is not None and rir_bank.dim() == 4:
        raise ValueError("a 4-D rir_bank carries a radius axis: pass its grid values via rir_bank_radii")
    elif rir_bank is not None and rir_bank.dim() not in (2, 3):
        raise ValueError("rir_bank must be (n_theta, n_sample), (n_t60, n_theta, n_sample), or the 4-D "
                         f"radius-gridded layout, got ndim {rir_bank.dim()}")
    if bank_mix_prob is not None and radius_range is not None and rir_bank_radii is None:
        raise ValueError(
            "bank_mix_prob with radius_range requires a radius-gridded bank (make_rir_bank(radii=...) + "
            "rir_bank_radii): a bank without a radius axis holds RIRs at the fixed config.R, so its samples' "
            "radius labels could not match their RIRs")
    if radius_range is not None:
        lo, hi = float(radius_range[0]), float(radius_range[1])
        max_r = max_source_radius(config)
        if not 0.0 < lo <= hi:
            raise ValueError(f"radius_range must satisfy 0 < lo <= hi, got {radius_range}")
        if hi >= max_r:
            raise ValueError(
                f"radius_range hi {hi} >= max in-room source radius {max_r} (receiver "
                f"{config.receiver_position[:2]} in room {config.room_dimensions[:2]}): sources would leave "
                "the room — source_coordinates clips only at the upper walls, so the image-source geometry "
                "and static image culling would be silently wrong")
    if snr_range is not None and not float(snr_range[0]) <= float(snr_range[1]):
        raise ValueError(f"snr_range must satisfy lo <= hi, got {snr_range}")
    if not 0.0 <= float(snr_clean_prob) <= 1.0:
        raise ValueError(f"snr_clean_prob must be in [0, 1], got {snr_clean_prob}")
    if snr_clean_prob and snr_range is None:
        raise ValueError("snr_clean_prob requires snr_range")
    if rir_bank is not None and rir_bank.shape[-1] != config.n_sample:
        raise ValueError(f"rir_bank n_sample {rir_bank.shape[-1]} != config.n_sample {config.n_sample}")


def snap_to_bank(theta: torch.Tensor, radius: torch.Tensor, n_theta: int, radii: Optional[torch.Tensor]):
    """The bank cells nearest a continuous geometry: the angle cell that
    holds ``theta`` and the grid radius nearest ``radius`` (the first on a
    tie); returns (angle index, radius index, the cell's angle, the grid
    radius), the radius index 0 and the radius unchanged without ``radii``."""
    cell = 2.0 * math.pi / n_theta
    t_idx = torch.clamp(torch.floor((theta + math.pi) / cell).long(), 0, n_theta - 1)
    grid = torch.from_numpy(bank_thetas(n_theta)).to(theta.device, theta.dtype)
    if radii is None:
        return t_idx, torch.zeros_like(t_idx), grid[t_idx], radius
    r_idx = torch.argmin(torch.abs(radius[:, None] - radii[None, :]), dim=1)
    return t_idx, r_idx, grid[t_idx], radii[r_idx]


def draw_synthesis(
    generator: torch.Generator,
    batch: int,
    config: DatasetConfig = DatasetConfig(),
    speech: Optional[torch.Tensor] = None,
    fixed_rir: bool = False,
    fixed_speech: bool = False,
    rt60_range: Optional[Sequence[float]] = None,
    radius_range: Optional[Sequence[float]] = None,
    theta: Optional[torch.Tensor] = None,
    radius=None,
    snr_range: Optional[Sequence[float]] = None,
    snr_clean_prob: float = 0.0,
    rir_bank: Optional[torch.Tensor] = None,
    rir_bank_radii=None,
    bank_mix_prob: Optional[float] = None,
) -> SynthDraws:
    """The draw step of :func:`synthesize_batch` (its options, same
    meanings), on the generator's device. The streams are drawn in one fixed
    order whatever the options — angle, T60, radius, SNR, clean mask, sensor
    noise, then the synthetic speech where no ``speech`` is given, then,
    with a ``rir_bank`` only, the bank's angle, T60 and radius cells and the
    mix mask — and the options only shape what was drawn: ``fixed_rir``
    repeats the first sample's drawn angle, radius and T60 (or bank cell),
    ``fixed_speech`` its utterance. A bank sample's labels are its cell's
    geometry: the angle of :func:`bank_thetas` and the grid radius."""
    if rir_bank_radii is not None:
        rir_bank_radii = torch.as_tensor(rir_bank_radii, dtype=torch.float32)
    _check_options(config, fixed_rir, rt60_range, radius_range, theta, radius, snr_range, snr_clean_prob,
                   rir_bank, rir_bank_radii, bank_mix_prob)
    dev = generator.device

    def first(a):
        return a[:1].expand(a.shape) if fixed_rir else a

    u_theta = -np.pi + 2 * np.pi * torch.rand(batch, generator=generator, device=dev)
    u_rt60 = torch.rand(batch, generator=generator, device=dev)
    u_radius = torch.rand(batch, generator=generator, device=dev)
    u_snr = torch.rand(batch, generator=generator, device=dev)
    u_clean = torch.rand(batch, generator=generator, device=dev)
    noise = torch.randn((batch, config.audio_samples), generator=generator, device=dev)
    if speech is None:
        speech = speech_from_draws(speech_draws(generator, batch, config.audio_samples, config.fs), config.fs)
    else:
        speech = torch.as_tensor(speech, dtype=torch.float32).to(dev)
    if fixed_speech:
        speech = speech[:1].expand(speech.shape)
    u_bank = None if rir_bank is None else torch.rand((4, batch), generator=generator, device=dev)

    if theta is not None:
        theta = torch.as_tensor(theta, dtype=torch.float32).to(dev).expand(batch)
    else:
        theta = first(u_theta)
    rt60 = None
    if rt60_range is not None:
        lo, hi = float(rt60_range[0]), float(rt60_range[1])
        rt60 = first(lo + (hi - lo) * u_rt60)
    if radius is not None:
        given = torch.as_tensor(radius, dtype=torch.float32)
        # a given radius bounds the cull by its largest value, so replaying
        # a drawn geometry culls the lattice the random run culled
        r_hi = float(given.max())
        radius = given.to(dev).expand(batch)
    elif radius_range is not None:
        lo, hi = float(radius_range[0]), float(radius_range[1])
        r_hi = hi
        radius = first(lo + (hi - lo) * u_radius)
    else:
        r_hi = float(config.R)
        radius = torch.full((batch,), float(config.R), device=dev)
    snr_db = clean = None
    if snr_range is not None:
        lo, hi = float(snr_range[0]), float(snr_range[1])
        snr_db = lo + (hi - lo) * u_snr
        if snr_clean_prob:
            clean = u_clean < float(snr_clean_prob)
    else:
        noise = None
    bank_index = use_bank = None
    if rir_bank is not None:
        n_t60, n_r, n_theta = _bank_view(rir_bank).shape[:3]
        radii = None if rir_bank_radii is None else rir_bank_radii.to(dev)
        cells = [torch.clamp((u * n).long(), max=n - 1) for u, n in zip(u_bank[:3], (n_theta, n_t60, n_r))]
        if bank_mix_prob is None:
            t_idx, t60_idx, r_idx = (first(c) for c in cells)
            theta = torch.from_numpy(bank_thetas(n_theta)).to(dev)[t_idx]
            if radii is not None:
                radius = radii[r_idx]
        else:  # the continuous draw, snapped to the bank's cells where the mask picks the bank
            t_idx, r_idx, theta_grid, radius_grid = snap_to_bank(theta, radius, n_theta, radii)
            t60_idx = cells[1]
            use_bank = u_bank[3] < float(bank_mix_prob)
            theta = torch.where(use_bank, theta_grid, theta)
            radius = torch.where(use_bank, radius_grid, radius)
        bank_index = torch.stack([t60_idx, r_idx, t_idx], dim=1)
    return SynthDraws(theta, radius, speech, rt60, snr_db, noise, clean, r_hi, bank_index, use_bank)


def add_sensor_noise(echoed: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor,
                     clean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``echoed`` (B, N) plus white ``noise`` scaled to ``snr_db`` below each
    sample's own power; the samples where ``clean`` is true stay clean."""
    p_sig = torch.mean(torch.square(echoed), dim=-1)
    noise_std = torch.sqrt(p_sig * torch.pow(10.0, -snr_db / 10.0))
    if clean is not None:
        noise_std = torch.where(clean, 0.0, noise_std)
    return echoed + noise_std[:, None] * noise


def rirs_from_draws(
    draws: SynthDraws,
    config: DatasetConfig = DatasetConfig(),
    fixed_rir: bool = False,
    rir_chunk: int = 8192,
    geom_cull: bool = True,
) -> torch.Tensor:
    """The (B, n_sample) RIRs of ``draws``' geometry and T60s (the config's
    T60 where none was drawn), on their device and in their dtype; with
    ``fixed_rir`` the first sample's RIR for every sample. ``geom_cull``:
    the lattice culled to the boxes of the draws' radius bound."""
    with span("synth.rir"):
        theta = draws.theta
        batch, dt, dev = theta.shape[0], theta.dtype, theta.device
        receiver = static_tensor(tuple(config.receiver_position), dt, dev)
        room = static_tensor(tuple(config.room_dimensions), dt, dev)
        src = source_coordinates(theta, receiver, room, radius=draws.radius, z_loc=config.Z_LOC_SOURCE)
        rir_kw = dict(room=tuple(config.room_dimensions), nsample=config.n_sample, fs=float(config.fs), c=config.c,
                      chunk=rir_chunk)
        if geom_cull:
            sbox, rbox = geometry_boxes(config, draws.r_hi)
            rir_kw.update(source_box=sbox, receiver_box=rbox)
        if draws.rt60 is None:
            rir_kw["rt60"] = config.reverberation_time
        n_rir = 1 if fixed_rir else batch
        h = generate_rir_batch(src[:n_rir], receiver, None if draws.rt60 is None else draws.rt60[:n_rir], **rir_kw)
        return h.expand(batch, -1)


def _sample_rirs(draws: SynthDraws, config: DatasetConfig, fixed_rir: bool, rir_chunk: int, geom_cull: bool,
                 rir_bank: Optional[torch.Tensor]) -> torch.Tensor:
    """Each sample's RIR: exact, or gathered from ``rir_bank`` where the
    draws picked the bank."""
    if draws.bank_index is None:
        return rirs_from_draws(draws, config, fixed_rir, rir_chunk, geom_cull)
    if rir_bank is None:
        raise ValueError("draws with bank cells need the rir_bank they were drawn from")
    bank = _bank_view(rir_bank)
    h = bank[tuple(draws.bank_index.to(bank.device).unbind(1))].to(draws.theta.device, draws.theta.dtype)
    if draws.use_bank is not None:
        h = torch.where(draws.use_bank[:, None], h, rirs_from_draws(draws, config, fixed_rir, rir_chunk, geom_cull))
    return h


def _echo(draws: SynthDraws, h: torch.Tensor) -> torch.Tensor:
    """The speech convolved with each RIR ('same'), plus the drawn sensor noise."""
    echoed = fft_convolve(draws.speech, h, mode="same")
    if draws.snr_db is not None:
        echoed = add_sensor_noise(echoed, draws.snr_db, draws.noise, draws.clean)
    return echoed


def echoed_from_draws(
    draws: SynthDraws,
    config: DatasetConfig = DatasetConfig(),
    fixed_rir: bool = False,
    rir_chunk: int = 8192,
    geom_cull: bool = True,
    rir_bank: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The echoed waveforms ``(B, audio_samples)`` of ``draws`` that
    :func:`synthesize_from_draws` takes its spectrograms of (same options),
    for a model that reads waveforms, as the neural codec does."""
    h = _sample_rirs(draws, config, fixed_rir, rir_chunk, geom_cull, rir_bank)
    with span("synth.spectra"):
        return _echo(draws, h)


def synthesize_from_draws(
    draws: SynthDraws,
    config: DatasetConfig = DatasetConfig(),
    fixed_rir: bool = False,
    rir_chunk: int = 8192,
    geom_cull: bool = True,
    rir_bank: Optional[torch.Tensor] = None,
) -> SampleBatch:
    """The deterministic core of :func:`synthesize_batch`: the batch of
    ``draws``, on their device and in their floating dtype (float32 or
    float64). ``fixed_rir``: one RIR, of the first sample, for every sample.
    Draws with bank cells gather those samples' RIRs from ``rir_bank`` (cast
    to the draws' dtype); where ``use_bank`` is false the RIR is exact."""
    theta, speech = draws.theta, draws.speech
    batch, dev = theta.shape[0], theta.device
    h = _sample_rirs(draws, config, fixed_rir, rir_chunk, geom_cull, rir_bank)
    with span("synth.spectra"):
        echoed = _echo(draws, h)
        speech_spec = _complex_spectrogram(speech, config)  # (B, F, T) complex, every frame
        echoed_spec = _complex_spectrogram(echoed, config)
        rir_spec = rir_spec_ratio(speech_spec, echoed_spec)  # each sample's max over all its frames
        wiener = wiener_estimate(speech_spec, echoed_spec)  # (B, F), over all frames
        return SampleBatch(
            speech_spec=_power_truncated(speech_spec, config),
            rir_spec=_power_truncated(rir_spec, config),
            echoed_spec=_power_truncated(echoed_spec, config),
            fs=torch.full((batch,), config.fs, dtype=torch.int32, device=dev),
            theta=theta,
            wiener_est=wiener,
            radius=draws.radius.expand(batch),
        )


def synthesize_batch(
    generator: torch.Generator,
    batch: int,
    config: DatasetConfig = DatasetConfig(),
    speech: Optional[torch.Tensor] = None,
    fixed_rir: bool = False,
    fixed_speech: bool = False,
    rir_chunk: int = 8192,
    rt60_range: Optional[Sequence[float]] = None,
    radius_range: Optional[Sequence[float]] = None,
    theta: Optional[torch.Tensor] = None,
    radius=None,
    snr_range: Optional[Sequence[float]] = None,
    snr_clean_prob: float = 0.0,
    geom_cull: bool = True,
    rir_bank: Optional[torch.Tensor] = None,
    rir_bank_radii=None,
    bank_mix_prob: Optional[float] = None,
    device="cuda",
) -> SampleBatch:
    """Synthesize ``batch`` samples on ``device`` (default the card; raises
    without one unless asked for ``"cpu"``), every random value drawn from
    ``generator``, which must lie on that device.

    ``speech``: (batch, audio_samples) waveforms of a corpus; default the
    synthetic source-filter speech. ``fixed_rir`` / ``fixed_speech``: the
    reference's ablations (genereate_dataset.py:12-16,32-35), every sample
    with the first one's RIR / utterance. ``rt60_range``: per-sample T60 ~
    U(lo, hi) (the reference pins 0.4 s). ``radius_range``: per-sample
    source radius ~ U(lo, hi), hi inside the room around the receiver.
    ``theta`` / ``radius``: given per-sample geometry ((batch,), the radius
    also a scalar) in place of the draws. ``snr_range``: white sensor noise
    on the echoed waveform at SNR ~ U(lo, hi) dB of each sample's power;
    ``snr_clean_prob``: each sample stays clean with this probability.
    ``geom_cull``: the RIR's lattice culled to the geometry's boxes.
    ``rir_chunk``: lattice images per step of the RIR's walk.

    ``rir_bank``: a bank of :func:`make_rir_bank` (on ``device``, where it
    is read once a batch). Each sample draws a uniform angle cell, and a
    uniform T60 cell of a 3-D or 4-D bank, and gathers that RIR in place of
    the image-source sum; its angle label is the cell's angle. Excludes
    ``rt60_range``, ``radius_range`` and a given ``theta``.
    ``rir_bank_radii``: the radius grid of a 4-D bank, required with one;
    each sample draws a uniform radius cell, its label the grid radius.
    ``bank_mix_prob``: per sample, with this probability the continuous
    draw is snapped to the bank (the angle's cell, the nearest grid radius,
    a uniform T60 cell) and gathered, else synthesized exactly; then
    ``rt60_range`` / ``radius_range`` shape the exact side (a radius range
    needs a radius-gridded bank). Labels always match the RIR used.
    """
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lies on {generator.device}, the batch is made on {device}")
    draws = draw_synthesis(generator, batch, config, speech, fixed_rir, fixed_speech, rt60_range, radius_range,
                           theta, radius, snr_range, snr_clean_prob, rir_bank, rir_bank_radii, bank_mix_prob)
    return synthesize_from_draws(draws, config, fixed_rir, rir_chunk, geom_cull, rir_bank)


def prune_batch(batch: SampleBatch, keep_fields, store_dtype=None) -> SampleBatch:
    """Shrink a batch for resident storage: the spectrogram fields not in
    ``keep_fields`` become empty (B, 0, 0) / (B, 0) placeholders, and the
    kept floating fields of two or more dimensions are cast to
    ``store_dtype`` (bf16 halves the memory; the trainer casts sampled rows
    back to float32). fs, theta and radius always stay."""
    def prune(name, a):
        if a.ndim == 3 and name not in keep_fields:
            return a.new_zeros((a.shape[0], 0, 0))
        if name == "wiener_est" and name not in keep_fields:
            return a.new_zeros((a.shape[0], 0))
        if store_dtype is not None and a.is_floating_point() and a.ndim >= 2:
            return a.to(store_dtype)
        return a

    return SampleBatch(*(prune(name, a) for name, a in zip(SampleBatch._fields, batch)))


def dataset_batches(
    generator: torch.Generator,
    size: int,
    config: DatasetConfig = DatasetConfig(),
    batch: int = 32,
    speech_pool=None,
    keep_fields=None,
    store_dtype=None,
    device="cuda",
    **kwargs,
):
    """Yield ``(row, part)``: the batches of a ``size``-sample dataset
    synthesized on ``device`` in turn from ``generator``, ``part`` holding
    rows ``row`` to ``row + len(part)``; the one loop of :func:`make_dataset`
    and :func:`.dataset.make_host_dataset`, whose arguments these are."""
    device = resolve_device(device)
    if size <= 0:
        raise ValueError(f"dataset size must be positive, got {size}")
    pool = None
    if speech_pool is not None:
        pool = torch.as_tensor(np.asarray(speech_pool, np.float32))
        if pool.shape[1] != config.audio_samples:
            raise ValueError(f"speech_pool length {pool.shape[1]} != config.audio_samples {config.audio_samples}")
        pool = pool.to(device)
    for i in range(0, size, batch):
        b = min(batch, size - i)
        kw = dict(kwargs)
        if pool is not None:
            kw["speech"] = pool[torch.randint(pool.shape[0], (b,), generator=generator, device=generator.device)]
        made = synthesize_batch(generator, b, config, device=device, **kw)
        if keep_fields is not None or store_dtype is not None:
            made = prune_batch(made, keep_fields if keep_fields is not None else SPEC_FIELDS, store_dtype)
        yield i, made


def make_dataset(
    generator: torch.Generator,
    size: int,
    config: DatasetConfig = DatasetConfig(),
    batch: int = 32,
    speech_pool=None,
    keep_fields=None,
    store_dtype=None,
    device="cuda",
    **kwargs,
) -> SampleBatch:
    """A ``size``-sample dataset synthesized on ``device`` batch by batch
    into one preallocated buffer (about 1.2 MB a sample in float32), the
    batches drawn from ``generator`` in turn. ``kwargs`` go to
    :func:`synthesize_batch`.

    ``speech_pool``: (n, audio_samples) corpus waveforms (e.g.
    :func:`..data.speech.load_wav_dir`); each sample convolves an utterance
    drawn uniformly from it (the reference's random LibriSpeech utterance,
    genereate_dataset.py:93-97). Default: the synthetic speech.
    ``keep_fields`` / ``store_dtype``: resident-storage compression as
    :func:`prune_batch`, applied batch by batch, so the transient footprint
    stays one batch."""
    buf = None
    for i, made in dataset_batches(generator, size, config, batch, speech_pool, keep_fields, store_dtype, device,
                                   **kwargs):
        if buf is None:
            buf = made.map(lambda a: a.new_zeros((size,) + tuple(a.shape[1:])))
        for dst, part in zip(buf, made):
            dst[i : i + part.shape[0]] = part
    return buf
