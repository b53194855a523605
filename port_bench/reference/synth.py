"""Plain PyTorch synthesis of echoed-speech samples: the reference of the
on-the-fly cell's synthesis.

A frozen copy of the port's image-source method (``dsp/rir.py``: the static
boxed lattice, the hoisted taps, the ``one_hot(block)^T @ taps`` sum), its
high-pass and FFT convolution (``dsp/filters.py``), its STFT (``dsp/stft.py``)
and its spectrogram features (``data/synth.py``), all of them the reference
generator's math (scripts/genereate_dataset.py:12-51). It computes in the
dtype of the draws (``draws.py``): float64 for the reference, float32 with
TF32 for the control. It imports nothing of the program.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from .model import matmul


# ------------------------------------------------------------ image sources


def _image_grid_bounds(room, nsample, fs, c, source_box, receiver_box):
    cTs = c / fs
    counts = [int(math.ceil(nsample / (2.0 * (dim / cTs)))) for dim in room]
    axes = [np.arange(-n, n + 1) for n in counts] + [np.arange(2)] * 3
    grid = np.meshgrid(*axes, indexing="ij")
    images = np.stack([g.reshape(-1) for g in grid], axis=1).astype(np.int32)
    L = np.asarray(room, np.float64) / cTs
    m = images[:, 0:3].astype(np.float64)
    q = images[:, 3:6].astype(np.float64)
    center = 2.0 * m * L[None, :]
    s_lo, s_hi = (np.asarray(v, np.float64) / cTs for v in source_box)
    r_lo, r_hi = (np.asarray(v, np.float64) / cTs for v in receiver_box)
    lo = np.where(q == 0, center + (s_lo - r_hi), center - (s_hi + r_hi))
    hi = np.where(q == 0, center + (s_hi - r_lo), center - (s_lo + r_lo))
    min_abs = np.where((lo <= 0.0) & (hi >= 0.0), 0.0, np.minimum(np.abs(lo), np.abs(hi)))
    max_abs = np.maximum(np.abs(lo), np.abs(hi))
    dist_lb = np.sqrt(np.sum(min_abs ** 2, axis=1))
    dist_ub = np.sqrt(np.sum(max_abs ** 2, axis=1))
    keep = dist_lb < nsample
    images, dist_lb, dist_ub = images[keep], dist_lb[keep], dist_ub[keep]
    order = np.argsort(0.5 * (dist_lb + dist_ub), kind="stable")
    return images[order], dist_lb[order], dist_ub[order]


@functools.lru_cache(maxsize=8)
def _chunked_lattice(room, nsample, fs, c, source_box, receiver_box, chunk):
    images, lb, ub = _image_grid_bounds(room, nsample, fs, c, source_box, receiver_box)
    pad = (-images.shape[0]) % chunk
    if pad:
        filler = np.zeros((pad, 6), np.int32)
        filler[:, 3] = -1
        images = np.concatenate([images, filler])
        lb = np.concatenate([lb, np.full(pad, lb[-1])])
        ub = np.concatenate([ub, np.full(pad, ub[-1])])
    n = images.shape[0] // chunk
    return images.reshape(n, chunk, 6), lb.reshape(n, chunk), ub.reshape(n, chunk)


def boxes(geometry: dict, r_hi: float):
    """The static source and receiver boxes of sources on circles of radius
    at most ``r_hi`` around the fixed receiver, upper-wall clipped."""
    rx, ry, rz = (float(v) for v in geometry["receiver_position"])
    lx, ly, lz = (float(v) for v in geometry["room_dimensions"])
    sz = min(rz + float(geometry["Z_LOC_SOURCE"]), lz)
    src = ((min(rx - r_hi, lx), min(ry - r_hi, ly), sz), (min(rx + r_hi, lx), min(ry + r_hi, ly), sz))
    return src, ((rx, ry, rz), (rx, ry, rz))


def highpass(x: torch.Tensor, fs: int) -> torch.Tensor:
    """The Habets generator's 100 Hz post high-pass, as a closed-form AR
    impulse response with its MA taps, FFT-convolved."""
    w = torch.full((), 2.0 * math.pi * 100.0 / fs, dtype=x.dtype, device=x.device)
    r1 = torch.exp(-w)
    a1 = -(1.0 + r1)
    n = x.shape[-1]
    m = torch.arange(n, dtype=x.dtype, device=x.device)
    h_ar = torch.exp(m * torch.log(r1)) * torch.sin((m + 1.0) * w) / torch.sin(w)
    z = torch.zeros(2, dtype=x.dtype, device=x.device)
    h = h_ar + a1 * torch.cat([z[:1], h_ar[:-1]]) + r1 * torch.cat([z, h_ar[:-2]])
    return fft_convolve(x, h, "full")[..., :n]


def rirs(theta, radius, rt60, geometry: dict, r_hi: float, chunk: int = 8192, block: int = 32) -> torch.Tensor:
    """(B, n_sample) room impulse responses of sources at ``theta``,
    ``radius`` with per-sample T60s ``rt60`` (None: the geometry's), in
    the dtype of ``theta``."""
    dtype, device = theta.dtype, theta.device
    batch = theta.shape[0]
    room = tuple(float(v) for v in geometry["room_dimensions"])
    fs, c, nsample = float(geometry["fs"]), float(geometry["c"]), int(geometry["n_sample"])
    receiver = torch.tensor(geometry["receiver_position"], dtype=dtype, device=device)
    offs = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                        torch.full_like(theta, float(geometry["Z_LOC_SOURCE"]))], dim=-1)
    src = torch.minimum(receiver + offs, torch.tensor(room, dtype=dtype, device=device))
    lx, ly, lz = room
    volume, surface = lx * ly * lz, 2.0 * (lx * ly + lx * lz + ly * lz)
    t60 = torch.full((batch,), float(geometry["reverberation_time"]), dtype=dtype, device=device) \
        if rt60 is None else rt60.to(dtype)
    alpha = 24.0 * volume * math.log(10.0) / (c * surface * t60)
    beta = torch.sqrt(torch.clamp(1.0 - alpha, min=0.0))[:, None]  # (B, 1), the same on every wall
    tw = 2 * int(round(0.004 * fs))
    half = tw // 2
    cTs = c / fs
    s, r = src / cTs, receiver / cTs
    L = torch.tensor(np.asarray(room, np.float64) / cTs, dtype=dtype, device=device)
    images_np, lbc, ubc = _chunked_lattice(room, nsample, fs, c, *boxes(geometry, r_hi), chunk)
    images = torch.from_numpy(images_np).to(device)

    g = block if (tw % block == 0 and block % 2 == 0) else tw
    W = g + tw
    f_over = W // g
    PAD = tw

    def blk_of(d):
        return (np.floor(d) - half + 1 + PAD) // g

    base_blk = blk_of(lbc.min(axis=1)).astype(np.int64)
    K = int((blk_of(ubc.max(axis=1)) - base_blk).max() + 1)
    n_gb = int(blk_of(float(nsample - 1)) + K + f_over + 2)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    n_rel_f = np.arange(W, dtype=np_dt)
    tap_c = torch.from_numpy(np.cos(2.0 * np.pi * n_rel_f / tw)).to(device)
    tap_s = torch.from_numpy(np.sin(2.0 * np.pi * n_rel_f / tw)).to(device)
    parity = torch.from_numpy(np.where(np.arange(W) % 2 == 0, 1.0, -1.0).astype(np_dt)).to(device)
    n_rel = torch.arange(W, dtype=torch.int32, device=device)
    acc = torch.zeros(batch, n_gb, W, dtype=dtype, device=device)
    for img, base in zip(images, base_blk.tolist()):
        m = img[:, 0:3].to(dtype)
        valid = img[:, 3] >= 0
        qjk = torch.clamp(img[:, 3:6].to(dtype), min=0.0)
        pos = (1.0 - 2.0 * qjk) * s[:, None, :] - r + 2.0 * m * L
        dist = torch.sqrt(torch.sum(pos * pos, dim=-1))
        # the six walls share one beta: the reflection is beta to the total order
        order = (torch.abs(m[:, 0] - qjk[:, 0]) + torch.abs(m[:, 0]) + torch.abs(m[:, 1] - qjk[:, 1])
                 + torch.abs(m[:, 1]) + torch.abs(m[:, 2] - qjk[:, 2]) + torch.abs(m[:, 2]))
        refl = beta ** order
        gain = refl / (4.0 * math.pi * torch.clamp(dist, min=1e-8) * cTs)
        fdist = torch.floor(dist)
        gain = torch.where(valid & (fdist < nsample), gain, 0.0)
        start_p = fdist.to(torch.int32) - half + 1 + PAD
        blk = torch.div(start_p, g, rounding_mode="floor")
        off = (start_p - blk * g)[..., None]
        p_abs = blk[..., None] * g + n_rel - PAD
        t = p_abs.to(dtype) - dist[..., None]
        active = (n_rel >= off) & (n_rel < off + tw)
        frac = dist - fdist
        e = dist - (blk * g - PAD).to(dtype)
        emod = e - tw * torch.floor(e / tw)
        fd_parity = (1.0 - 2.0 * torch.remainder(fdist, 2.0))[..., None]
        cos_e = torch.cos(2.0 * math.pi * emod / tw)[..., None]
        sin_e = torch.sin(2.0 * math.pi * emod / tw)[..., None]
        sin_pe = fd_parity * torch.sin(math.pi * frac)[..., None]
        window = 0.5 * (1.0 + tap_c * cos_e + tap_s * sin_e)
        sinc = torch.where(t == 0.0, 1.0, -parity * sin_pe / (math.pi * t + 1e-30))
        vals = torch.where(active, gain[..., None] * window * sinc, 0.0)
        loc = torch.clamp(blk - base, 0, K - 1)
        onehot = torch.nn.functional.one_hot(loc.long(), K).to(dtype)
        at = min(base, n_gb - K)
        acc[:, at: at + K] += matmul(onehot.transpose(1, 2), vals)
    pieces = acc.reshape(batch, n_gb, f_over, g)
    folded = torch.zeros(batch, n_gb + f_over - 1, g, dtype=dtype, device=device)
    for q in range(f_over):
        folded[:, q: q + n_gb] += pieces[:, :, q]
    imp = folded.reshape(batch, -1)[:, PAD: PAD + nsample]
    return highpass(imp, int(fs))


# ------------------------------------------------------------- spectrograms


def fft_convolve(x: torch.Tensor, h: torch.Tensor, mode: str = "same") -> torch.Tensor:
    """``scipy.signal.convolve(x, h, mode)`` along the last axis by FFT."""
    n, m = x.shape[-1], h.shape[-1]
    full = n + m - 1
    size = 1 << (full - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, size) * torch.fft.rfft(h, size), size)[..., :full]
    if mode == "full":
        return y
    start = (m - 1) // 2
    return y[..., start: start + n]


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """torchaudio's ``Spectrogram(power=None, normalized=True)``: centred,
    reflect-padded, periodic Hann, divided by ``sqrt(sum(window^2))``."""
    n = n_fft + 1
    w = (0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(n, dtype=x.dtype, device=x.device) / (n - 1))))[:n_fft]
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=w, center=True, pad_mode="reflect",
                      normalized=False, onesided=True, return_complex=True)
    return spec / torch.sqrt(torch.sum(w * w))


def samples(draws: Dict[str, torch.Tensor], geometry: dict, h: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Echoed-speech samples of ``draws`` (theta, radius, rt60, speech,
    snr_db, noise, clean, r_hi): the RIRs (or ``h``), the echoed waveform
    with its sensor noise, and the power spectrograms truncated to
    ``num_frames`` (genereate_dataset.py:38-51)."""
    if h is None:
        h = rirs(draws["theta"], draws["radius"], draws.get("rt60"), geometry, float(draws["r_hi"]))
    speech = draws["speech"]
    echoed = fft_convolve(speech, h.to(speech.dtype), "same")
    if draws.get("snr_db") is not None:
        p_sig = torch.mean(echoed * echoed, dim=-1)
        std = torch.sqrt(p_sig * torch.pow(10.0, -draws["snr_db"] / 10.0))
        if draws.get("clean") is not None:
            std = torch.where(draws["clean"], 0.0, std)
        echoed = echoed + std[:, None] * draws["noise"]
    nf, hop, frames = int(geometry["NFFT"]), int(geometry["HOP_LENGTH"]), int(geometry["num_frames"])
    s_spec, e_spec = stft(speech, nf, hop), stft(echoed, nf, hop)
    return {
        "echoed_spec": (torch.abs(e_spec) ** 2)[..., :frames],
        "speech_spec": (torch.abs(s_spec) ** 2)[..., :frames],
        "theta": draws["theta"],
        "radius": draws["radius"],
    }
