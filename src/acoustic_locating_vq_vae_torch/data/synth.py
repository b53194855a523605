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
giving the geometry a random run drew reproduces that run. Not ported yet:
the RIR bank (``rir_bank``, ``rir_bank_radii``, ``bank_mix_prob``,
``make_rir_bank``, ``bank_thetas``) and host-staged datasets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..dsp.filters import fft_convolve
from ..dsp.rir import generate_rir_batch
from ..dsp.specs import rir_spec_ratio, source_coordinates, wiener_estimate
from ..dsp.stft import spectrogram
from ..utils.device import resolve_device
from .config import DatasetConfig
from .speech import speech_draws, speech_from_draws

__all__ = [
    "SampleBatch",
    "SynthDraws",
    "add_sensor_noise",
    "draw_synthesis",
    "geometry_boxes",
    "make_dataset",
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

    def to(self, device=None, dtype=None) -> "SynthDraws":
        """The draws on ``device``, floating tensors cast to ``dtype``."""
        def move(a):
            if not isinstance(a, torch.Tensor):
                return a
            return a.to(device=device, dtype=dtype if dtype is not None and a.is_floating_point() else None)

        return SynthDraws(*(move(a) for a in self))


def _check_options(config, radius_range, radius, snr_range, snr_clean_prob) -> None:
    """The option errors of the JAX ``synthesize_batch`` that apply without a RIR bank."""
    if radius is not None and radius_range is not None:
        raise ValueError("given radius excludes radius_range")
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
) -> SynthDraws:
    """The draw step of :func:`synthesize_batch` (its options, same
    meanings), on the generator's device. The streams are drawn in one fixed
    order whatever the options — angle, T60, radius, SNR, clean mask, sensor
    noise, then the synthetic speech where no ``speech`` is given — and the
    options only shape what was drawn: ``fixed_rir`` repeats the first
    sample's drawn angle, radius and T60, ``fixed_speech`` its utterance."""
    _check_options(config, radius_range, radius, snr_range, snr_clean_prob)
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
    return SynthDraws(theta, radius, speech, rt60, snr_db, noise, clean, r_hi)


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
    theta = draws.theta
    batch, dt, dev = theta.shape[0], theta.dtype, theta.device
    receiver = torch.tensor(config.receiver_position, dtype=dt).to(dev)
    room = torch.tensor(config.room_dimensions, dtype=dt).to(dev)
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


def synthesize_from_draws(
    draws: SynthDraws,
    config: DatasetConfig = DatasetConfig(),
    fixed_rir: bool = False,
    rir_chunk: int = 8192,
    geom_cull: bool = True,
) -> SampleBatch:
    """The deterministic core of :func:`synthesize_batch`: the batch of
    ``draws``, on their device and in their floating dtype (float32 or
    float64). ``fixed_rir``: one RIR, of the first sample, for every sample."""
    theta, speech = draws.theta, draws.speech
    batch, dev = theta.shape[0], theta.device
    h = rirs_from_draws(draws, config, fixed_rir, rir_chunk, geom_cull)
    echoed = fft_convolve(speech, h, mode="same")
    if draws.snr_db is not None:
        echoed = add_sensor_noise(echoed, draws.snr_db, draws.noise, draws.clean)
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
    """
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lies on {generator.device}, the batch is made on {device}")
    draws = draw_synthesis(generator, batch, config, speech, fixed_rir, fixed_speech, rt60_range, radius_range,
                           theta, radius, snr_range, snr_clean_prob)
    return synthesize_from_draws(draws, config, fixed_rir, rir_chunk, geom_cull)


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
    device = resolve_device(device)
    if size <= 0:
        raise ValueError(f"dataset size must be positive, got {size}")
    pool = None
    if speech_pool is not None:
        pool = torch.as_tensor(np.asarray(speech_pool, np.float32))
        if pool.shape[1] != config.audio_samples:
            raise ValueError(f"speech_pool length {pool.shape[1]} != config.audio_samples {config.audio_samples}")
        pool = pool.to(device)
    buf = None
    for i in range(0, size, batch):
        b = min(batch, size - i)
        kw = dict(kwargs)
        if pool is not None:
            kw["speech"] = pool[torch.randint(pool.shape[0], (b,), generator=generator, device=generator.device)]
        made = synthesize_batch(generator, b, config, device=device, **kw)
        if keep_fields is not None or store_dtype is not None:
            made = prune_batch(made, keep_fields if keep_fields is not None else SPEC_FIELDS, store_dtype)
        if buf is None:
            buf = made.map(lambda a: a.new_zeros((size,) + tuple(a.shape[1:])))
        for dst, part in zip(buf, made):
            dst[i : i + b] = part
    return buf
