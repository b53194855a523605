"""Image-source room impulse responses, a batch at a time.

Counterpart of ``acoustic_locating_vq_vae_tpu/dsp/rir.py:56-439``, the
redesign of the reference's ``rir.generate(c, fs, r, s, L,
reverberation_time, nsample)`` (the Habets image-source C++ core,
genereate_dataset.py:21-29). The same math, carried over with a batch axis
of its own in place of the JAX package's ``vmap`` over sources:

  * the image lattice is a static, (room, nsample)-dependent enumeration
    (numpy, cached), culled of the images that cannot reach the window and
    sorted by their static distance bounds; it is walked in chunks;
  * each image's ``tw`` active taps lie inside a (g + tw)-wide g-aligned
    window, so the taps of a chunk are a (B, chunk, W) tensor and their
    accumulation is ``one_hot(block)ᵀ @ taps`` over the K blocks the chunk
    can reach, a (B, K, chunk) x (B, chunk, W) batched matmul added into the
    output's static slice ``[base, base + K)``: no scatter, so two runs on
    the card are bitwise equal (``index_add_`` on CUDA floats is not);
  * the three transcendentals of a tap are hoisted to three per image, with
    the window-local range reduction (``emod``) that keeps ``sin(pi*d)``
    exact at d of several thousand samples;
  * the 100 Hz high-pass is :func:`..filters.highpass_habets`.

That is the plain version, which serves CPU tensors. On a CUDA tensor the
taps are built by the hand-written kernel ``csrc/rir_taps.cu`` through the
registered operator :func:`rir_taps` (its CUDA implementation is
``ops/rir_cuda.py:rir_taps_cuda``), or the call raises: the same taps, each
output sample summed in float64 in a fixed order from a static plan
(:func:`_tap_plan`: for each segment of the output, the lattice rows whose
taps can land in it), so two runs on the card are bitwise equal too. The plan
bounds each row by the positions that the cull's intervals allow (the room,
or the boxes), with or without ``cull``: on the card, ``cull=False`` gives
the culled result, exact while the positions lie inside those intervals.
``chunk`` and ``block`` shape the plain version's walk alone.

``method="scatter"`` accumulates the same taps with ``scatter_add_``: a
cross-check of the matmul formulation on the CPU, refused on the card. The
arithmetic follows the floating dtype of ``sources`` (float32, as the JAX
package, or float64); the matmul runs in full FP32 (TF32 off).

Parity with the Habets core: Sabine's beta from T60, uniform over the six
walls; n_i = ceil(nsample / (2 L_i / cTs)) images per axis; the tap at p is
gain * 0.5 (1 + cos(2 pi (p - d) / Tw)) * sinc(p - d) for p in
[floor(d) - Tw/2 + 1, floor(d) + Tw/2], Tw = 2 round(0.004 fs); gain =
prod beta^|.| / (4 pi d cTs); images with floor(d) >= nsample dropped.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rir_cuda import rir_taps_cuda
from ..utils.device import full_fp32, static_tensor
from .filters import highpass_habets

__all__ = ["RIR_TAPS_OP", "beta_from_rt60", "beta_from_rt60_traced", "generate_rir", "generate_rir_batch", "rir_taps"]

# the tap kernel's operator, in the package's own namespace
RIR_TAPS_OP = "acoustic_locating_vq_vae_torch::rir_taps"


def beta_from_rt60(room: Sequence[float], rt60: float, c: float = 340.0) -> float:
    """Uniform wall reflection coefficient from Sabine's formula (Habets core)."""
    lx, ly, lz = float(room[0]), float(room[1]), float(room[2])
    volume = lx * ly * lz
    surface = 2.0 * (lx * ly + lx * lz + ly * lz)
    alpha = 24.0 * volume * math.log(10.0) / (c * surface * rt60)
    if alpha > 1.0:
        raise ValueError(f"T60={rt60} is too small for room {room!r} (Sabine absorption {alpha:.3f} > 1)")
    return math.sqrt(1.0 - alpha)


def beta_from_rt60_traced(room: Sequence[float], rt60: torch.Tensor, c: float = 340.0) -> torch.Tensor:
    """Sabine's beta of a tensor of T60s (per-sample reverberation). Outside
    Sabine's validity (absorption > 1) it is 0, not an error, as in the JAX
    package; callers keep their T60 range valid for the room."""
    lx, ly, lz = float(room[0]), float(room[1]), float(room[2])
    volume = lx * ly * lz
    surface = 2.0 * (lx * ly + lx * lz + ly * lz)
    rt60 = torch.as_tensor(rt60)
    rt60 = rt60 if rt60.dtype == torch.float64 else rt60.float()
    den = c * surface * rt60
    alpha = torch.full_like(den, 24.0 * volume * math.log(10.0)) / den
    return torch.sqrt(torch.clamp(1.0 - alpha, min=0.0))


def _image_grid_bounds(
    room: Sequence[float], nsample: int, fs: float, c: float, cull: bool = True,
    source_box=None, receiver_box=None,
):
    """The image-source lattice and each image's static distance bounds,
    sorted by the midpoint of those bounds (numpy; the port's own copy of the
    JAX package's ``dsp/rir.py:82-158``).

    ``cull=True`` drops the lattice rows that cannot land inside the
    ``nsample``-tap window for any source and receiver inside the room
    (interval arithmetic on pos_i = ±s_i − r_i + 2 m_i L_i with s_i, r_i in
    [0, L_i]); the kept set holds every image that can contribute.
    ``source_box`` / ``receiver_box``: optional per-axis position bounds
    ``((lox, loy, loz), (hix, hiy, hiz))`` in meters that replace the room's
    intervals, for a tighter cull; exact while the positions lie inside them.
    Returns ``(images (N, 6) int32 [mx, my, mz, q, j, k], dist_lb (N,),
    dist_ub (N,))``.
    """
    cTs = c / fs
    counts = [int(math.ceil(nsample / (2.0 * (dim / cTs)))) for dim in room]
    n1, n2, n3 = counts
    mx = np.arange(-n1, n1 + 1)
    my = np.arange(-n2, n2 + 1)
    mz = np.arange(-n3, n3 + 1)
    bits = np.arange(2)
    grid = np.meshgrid(mx, my, mz, bits, bits, bits, indexing="ij")
    images = np.stack([g.reshape(-1) for g in grid], axis=1).astype(np.int32)
    L = np.asarray(room, np.float64) / cTs  # room in sample units
    m = images[:, 0:3].astype(np.float64)
    q = images[:, 3:6].astype(np.float64)
    center = 2.0 * m * L[None, :]

    def _box(box):
        if box is None:
            return np.zeros(3), L.copy()
        lo = np.asarray(box[0], np.float64) / cTs
        hi = np.asarray(box[1], np.float64) / cTs
        if lo.shape != (3,) or hi.shape != (3,) or np.any(lo > hi):
            raise ValueError(f"box must be ((lox,loy,loz),(hix,hiy,hiz)) with lo<=hi, got {box!r}")
        return lo, hi

    s_lo, s_hi = _box(source_box)
    r_lo, r_hi = _box(receiver_box)
    # q=0: pos_i = s_i - r_i + 2 m_i L_i  in [c + s_lo - r_hi, c + s_hi - r_lo]
    # q=1: pos_i = -s_i - r_i + 2 m_i L_i in [c - s_hi - r_hi, c - s_lo - r_lo]
    lo = np.where(q == 0, center + (s_lo - r_hi), center - (s_hi + r_hi))
    hi = np.where(q == 0, center + (s_hi - r_lo), center - (s_lo + r_lo))
    min_abs = np.where((lo <= 0.0) & (hi >= 0.0), 0.0, np.minimum(np.abs(lo), np.abs(hi)))
    max_abs = np.maximum(np.abs(lo), np.abs(hi))
    dist_lb = np.sqrt(np.sum(min_abs**2, axis=1))
    dist_ub = np.sqrt(np.sum(max_abs**2, axis=1))
    if cull:
        # an image contributes iff floor(dist) < nsample, i.e. dist < nsample
        keep = dist_lb < nsample
        images, dist_lb, dist_ub = images[keep], dist_lb[keep], dist_ub[keep]
    order = np.argsort(0.5 * (dist_lb + dist_ub), kind="stable")
    return images[order], dist_lb[order], dist_ub[order]


@functools.lru_cache(maxsize=16)
def _chunked_lattice(room, nsample, fs, c, cull, source_box, receiver_box, chunk):
    """The sorted lattice padded to whole chunks: (n_chunks, chunk, 6) images
    and (n_chunks, chunk) distance bounds. Padding rows carry q = -1 (masked
    out) and the last real row's bounds, so a chunk's block range stays
    tight."""
    images, dist_lb, dist_ub = _image_grid_bounds(
        room, nsample, fs, c, cull=cull, source_box=source_box, receiver_box=receiver_box)
    pad = (-images.shape[0]) % chunk
    if pad:
        filler = np.zeros((pad, 6), np.int32)
        filler[:, 3] = -1
        images = np.concatenate([images, filler])
        dist_lb = np.concatenate([dist_lb, np.full(pad, dist_lb[-1])])
        dist_ub = np.concatenate([dist_ub, np.full(pad, dist_ub[-1])])
    n_chunks = images.shape[0] // chunk
    return images.reshape(n_chunks, chunk, 6), dist_lb.reshape(n_chunks, chunk), dist_ub.reshape(n_chunks, chunk)


# the card's streaming multiprocessors (H100): a launch should give each a few blocks
_CARD_SMS = 132


def _segment_size(nsample: int, batch: int) -> int:
    """Output samples per block of the tap kernel (one a thread): 128 where
    that gives the card four blocks an SM or more, else 64. (At B = 64 and
    6,400 taps 128 took 4.95 ms, 256 5.75 ms and 64 5.16 ms on an H100:
    PERF.md.)"""
    return 128 if batch * -(-nsample // 128) >= 4 * _CARD_SMS else 64


@functools.lru_cache(maxsize=16)
def _tap_plan(room, nsample, fs, c, cull, source_box, receiver_box, order, tw, seg):
    """The tap kernel's static plan (numpy): the output cut into segments of
    ``seg`` samples, and for each segment the lattice rows whose taps can
    land in it, in the lattice's order.

    A row's taps lie in ``[floor(d) - tw/2 + 1, floor(d) + tw/2]`` and its
    distance d in ``[dist_lb, dist_ub]`` (:func:`_image_grid_bounds`, the
    room's or the boxes' intervals); ``floor(d)`` is widened by one sample
    each way for the rounding of d in float32. Rows whose ``floor(d)``
    cannot lie below ``nsample`` and rows of more reflections than
    ``order >= 0`` allows are left out. Returns ``(entries (P, 4) int32 [mx,
    my, mz, qx | qy << 1 | qz << 2], slot_ptr (n_seg + 1,) int32, slot_seg
    (n_seg,) int32, rows, max_pow)``: the segments' lists one after another,
    the segment with the longest list first (slot k holds segment
    ``slot_seg[k]``, its rows ``entries[slot_ptr[k]:slot_ptr[k + 1]]``),
    ``rows`` the lattice rows listed and ``max_pow`` the largest power of a
    wall's beta that a listed row takes."""
    images, dist_lb, dist_ub = _image_grid_bounds(
        room, nsample, fs, c, cull=cull, source_box=source_box, receiver_box=receiver_box)
    half = tw // 2
    fd_lo = np.floor(dist_lb).astype(np.int64) - 1
    fd_hi = np.floor(dist_ub).astype(np.int64) + 1
    keep = fd_lo < nsample
    if order >= 0:
        m, q = images[:, 0:3].astype(np.int64), images[:, 3:6].astype(np.int64)
        keep &= np.abs(2 * m - q).sum(axis=1) <= order
    images, fd_lo, fd_hi = images[keep], fd_lo[keep], fd_hi[keep]
    first = np.maximum(fd_lo - half + 1, 0) // seg
    last = np.minimum(fd_hi + half, nsample - 1) // seg
    n_seg = -(-nsample // seg)
    reach = last - first + 1
    row = np.repeat(np.arange(images.shape[0]), reach)
    segment = np.repeat(first, reach) + (np.arange(row.shape[0]) - np.repeat(np.cumsum(reach) - reach, reach))
    per_seg = np.bincount(segment, minlength=n_seg)
    slot_seg = np.argsort(-per_seg, kind="stable")
    slot_of = np.empty(n_seg, np.int64)
    slot_of[slot_seg] = np.arange(n_seg)
    by_slot = np.argsort(slot_of[segment], kind="stable")  # keeps the lattice's order within a segment
    packed = np.stack([images[:, 0], images[:, 1], images[:, 2],
                       images[:, 3] | (images[:, 4] << 1) | (images[:, 5] << 2)], axis=1).astype(np.int32)
    slot_ptr = np.concatenate([[0], np.cumsum(per_seg[slot_seg])]).astype(np.int32)
    max_pow = int(np.abs(images[:, 0:3]).max(initial=0)) + 1
    return (np.ascontiguousarray(packed[row[by_slot]]), slot_ptr, slot_seg.astype(np.int32), int(images.shape[0]),
            max_pow)


@functools.lru_cache(maxsize=16)
def _card_plan(room, nsample, fs, c, cull, source_box, receiver_box, order, tw, seg, dtype, device):
    """:func:`_tap_plan` on ``device``, with the taps' table ``(2, tw + 1)``
    of cos and sin of ``2 pi n / tw`` in ``dtype``: copied once per geometry."""
    entries, slot_ptr, slot_seg, rows, max_pow = _tap_plan(
        room, nsample, fs, c, cull, source_box, receiver_box, order, tw, seg)
    n = np.arange(tw + 1, dtype=np.float64)
    table = np.stack([np.cos(2.0 * np.pi * n / tw), np.sin(2.0 * np.pi * n / tw)])
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return on(entries), on(slot_ptr), on(slot_seg), on(table).to(dtype), rows, max_pow


def _betas(room, c, batch, dtype, device, rt60, beta, beta_traced) -> torch.Tensor:
    """The (batch, 6) wall reflection coefficients from exactly one of a
    static ``rt60``, a static ``beta`` (scalar or six) or a tensor
    ``beta_traced`` (scalar or six), the same for every source."""
    if beta_traced is not None:
        if rt60 is not None or beta is not None:
            raise ValueError("beta_traced excludes the static rt60 / beta")
        bt = torch.as_tensor(beta_traced).to(device=device, dtype=dtype)
        if bt.shape not in ((), (6,)):
            raise ValueError(f"beta_traced must be scalar or (6,), got {tuple(bt.shape)}")
        return bt.expand(6).expand(batch, 6)
    if (rt60 is None) == (beta is None):
        raise ValueError("specify exactly one of rt60 / beta / beta_traced")
    if beta is None:
        vals = (beta_from_rt60(room, rt60, c),) * 6
    elif isinstance(beta, (int, float)):
        vals = (float(beta),) * 6
    else:
        vals = tuple(float(b) for b in beta)
        if len(vals) != 6:
            raise ValueError("beta must be scalar or length-6")
    return static_tensor(vals, dtype, torch.device(device)).expand(batch, 6)


def generate_rir_batch(
    sources: torch.Tensor,
    receiver,
    rt60_traced: Optional[torch.Tensor] = None,
    *,
    room: tuple,
    nsample: int,
    fs: float,
    c: float = 340.0,
    rt60: Optional[float] = None,
    beta=None,
    beta_traced: Optional[torch.Tensor] = None,
    order: int = -1,
    tw: Optional[int] = None,
    hp: bool = True,
    method: str = "block_matmul",
    chunk: int = 16384,
    cull: bool = True,
    block: int = 32,
    source_box: Optional[tuple] = None,
    receiver_box: Optional[tuple] = None,
) -> torch.Tensor:
    """RIRs of a (B, 3) batch of source positions in meters for one receiver
    (3,) in a static room; returns (B, nsample) on the sources' device, in
    their floating dtype (float64 stays float64, anything else is float32).

    ``rt60_traced``: (B,) per-sample reverberation times, each source with
    its own Sabine beta; excludes ``rt60`` / ``beta`` / ``beta_traced``.
    Otherwise exactly one of ``rt60`` (static), ``beta`` (static, scalar or
    six walls) or ``beta_traced`` (a tensor, scalar or six walls, for every
    source).

    ``cull``: drop the lattice images that cannot reach the window for any
    in-room source and receiver; ``source_box`` / ``receiver_box`` tighten
    that cull to the positions' bounds (exact while the positions lie inside
    them; ``data.synth`` derives them from the geometry it draws from).
    ``block``: the accumulation block g (must be even and divide ``tw``,
    else ``tw``); ``chunk``: images per step of the walk. Both shape the
    plain version's walk, which serves CPU tensors; a CUDA tensor's taps are
    the kernel's (``csrc/rir_taps.cu``), with the plan's own segments.
    """
    if sources.ndim != 2 or sources.shape[1] != 3:
        raise ValueError(f"sources must be (B, 3), got {tuple(sources.shape)}")
    if method not in ("block_matmul", "scatter"):
        raise ValueError(f"unknown method {method!r}")
    if method == "scatter" and sources.device.type != "cpu":
        raise ValueError("method='scatter' is the CPU cross-check: on the card its atomics make two runs "
                         "differ bitwise; use method='block_matmul'")
    device = sources.device
    dtype = torch.float64 if sources.dtype == torch.float64 else torch.float32
    batch = sources.shape[0]
    if rt60_traced is not None:
        if rt60 is not None or beta is not None or beta_traced is not None:
            raise ValueError("rt60_traced excludes the static rt60 / beta kwargs")
        if tuple(rt60_traced.shape) != (batch,):
            raise ValueError(f"rt60_traced must be ({batch},), got {tuple(rt60_traced.shape)}")
        betas = beta_from_rt60_traced(room, rt60_traced, c).to(device=device, dtype=dtype)[:, None].expand(batch, 6)
    else:
        betas = _betas(room, c, batch, dtype, device, rt60, beta, beta_traced)
    if tw is None:
        tw = 2 * int(round(0.004 * fs))  # 8 ms FIR, 128 taps at 16 kHz
    if method == "block_matmul" and tw % 2:
        raise ValueError(f"block_matmul requires even tw (got {tw}): the hoisted tap parity assumes "
                         "(-1)^p == (-1)^n within a window; use method='scatter' for odd tap counts")

    sources = sources.to(dtype)
    receiver = torch.as_tensor(receiver).to(device=device, dtype=dtype)
    kw = dict(room=tuple(float(v) for v in room), nsample=int(nsample), fs=float(fs), c=float(c), order=int(order),
              tw=int(tw), cull=bool(cull), source_box=source_box, receiver_box=receiver_box)
    if device.type == "cuda":
        imp = _kernel_taps(sources, receiver, betas, **kw)
    elif device.type == "cpu":
        imp = _plain_taps(sources, receiver, betas, method=method, chunk=int(chunk), block=block, **kw)
    else:
        raise ValueError(f"no image-source tap build for device {device}: CPU tensors take the plain version, "
                         "CUDA tensors the kernel")
    return highpass_habets(imp, int(fs)) if hp else imp


@torch.library.custom_op(RIR_TAPS_OP, mutates_args=(), device_types="cuda")
def rir_taps(sources: torch.Tensor, receiver: torch.Tensor, betas: torch.Tensor, entries: torch.Tensor,
             slot_ptr: torch.Tensor, slot_seg: torch.Tensor, table: torch.Tensor, nsample: int, seg: int,
             max_pow: int, room: List[float], c_ts: float) -> torch.Tensor:
    """The tap kernel (``ops/rir_cuda.py:rir_taps_cuda``) as one registered
    operator, so that a profile sees the launch as an operation inside the
    caller's span. CUDA only: CPU tensors take the plain version."""
    # the module's name is read at each call, so a wrapper put in its place (a launch counter) is the one called
    return rir_taps_cuda(sources, receiver, betas, entries, slot_ptr, slot_seg, table, nsample, seg, max_pow, room,
                         c_ts)


@rir_taps.register_fake
def _rir_taps_fake(sources, receiver, betas, entries, slot_ptr, slot_seg, table, nsample, seg, max_pow, room, c_ts):
    return sources.new_empty((sources.shape[0], nsample))


def _kernel_taps(sources, receiver, betas, *, room, nsample, fs, c, order, tw, cull, source_box, receiver_box):
    """The unfiltered taps of CUDA tensors: the registered operator
    ``rir_taps`` over the geometry's plan, one launch."""
    seg = _segment_size(nsample, sources.shape[0])
    entries, slot_ptr, slot_seg, table, _, max_pow = _card_plan(
        room, nsample, fs, c, cull, source_box, receiver_box, order, tw, seg, sources.dtype, sources.device)
    cTs = c / fs
    return rir_taps(sources.contiguous(), receiver.contiguous(), betas, entries, slot_ptr, slot_seg, table, nsample,
                    seg, max_pow, [v / cTs for v in room], cTs)


def _plain_taps(sources, receiver, betas, *, room, nsample, fs, c, order, tw, cull, source_box, receiver_box,
                method, chunk, block):
    """The unfiltered taps, plain version: the chunked walk of the lattice,
    summed by ``_block_matmul`` (or ``scatter_add_``). Serves CPU tensors;
    ``chip_smoke.py`` and the card tests also run it on the card, as the
    kernel's yardstick."""
    device, dtype, batch = sources.device, sources.dtype, sources.shape[0]
    cTs = c / fs
    s = sources / cTs
    r = receiver / cTs
    L = torch.tensor(np.asarray(room, np.float64) / cTs, dtype=dtype).to(device)
    images_np, lbc, ubc = _chunked_lattice(room, nsample, fs, c, cull, source_box, receiver_box, chunk)
    images = torch.from_numpy(images_np).to(device)
    half = tw // 2

    def image_gains(img):
        """img (chunk, 6) -> dist, gain (B, chunk), invalid rows' gain 0."""
        m = img[:, 0:3].to(dtype)
        valid = img[:, 3] >= 0
        qjk = torch.clamp(img[:, 3:6].to(dtype), min=0.0)
        pos = (1.0 - 2.0 * qjk) * s[:, None, :] - r + 2.0 * m * L  # (B, chunk, 3) in samples
        dist = torch.sqrt(torch.sum(pos * pos, dim=-1))
        b = betas[:, None, :]
        refl = (
            b[..., 0] ** torch.abs(m[:, 0] - qjk[:, 0]) * b[..., 1] ** torch.abs(m[:, 0])
            * b[..., 2] ** torch.abs(m[:, 1] - qjk[:, 1]) * b[..., 3] ** torch.abs(m[:, 1])
            * b[..., 4] ** torch.abs(m[:, 2] - qjk[:, 2]) * b[..., 5] ** torch.abs(m[:, 2])
        )
        gain = refl / (4.0 * math.pi * torch.clamp(dist, min=1e-8) * cTs)
        fdist = torch.floor(dist)
        keep = valid & (fdist < nsample)
        if order >= 0:
            refl_count = (torch.abs(2.0 * m[:, 0] - qjk[:, 0]) + torch.abs(2.0 * m[:, 1] - qjk[:, 1])
                          + torch.abs(2.0 * m[:, 2] - qjk[:, 2]))
            keep = keep & (refl_count <= order)
        return dist, torch.where(keep, gain, 0.0)

    with full_fp32():
        if method == "block_matmul":
            imp = _block_matmul(images, lbc, ubc, image_gains, batch, nsample, tw, block, dtype, device)
        else:
            acc = torch.zeros(batch, nsample + 2 * tw, dtype=dtype, device=device)
            n_rel = torch.arange(tw, dtype=torch.int32, device=device)
            for img in images:
                dist, gain = image_gains(img)
                p_abs = torch.floor(dist).to(torch.int32)[..., None] - half + 1 + n_rel  # (B, chunk, tw)
                t = p_abs.to(dtype) - dist[..., None]
                window = 0.5 * (1.0 + torch.cos(2.0 * math.pi * t / tw))
                sinc = torch.where(t == 0.0, 1.0, torch.sin(math.pi * t) / (math.pi * t + 1e-30))
                vals = torch.where(p_abs >= -tw, gain[..., None] * window * sinc, 0.0).reshape(batch, -1)
                idx = torch.clamp(p_abs + tw, 0, nsample + 2 * tw - 1).reshape(batch, -1).long()
                acc.scatter_add_(1, idx, vals)
            imp = acc[:, tw : tw + nsample]
    return imp


def _block_matmul(images, lbc, ubc, image_gains, batch, nsample, tw, block, dtype, device):
    """The taps of every chunk accumulated by ``one_hot(block)ᵀ @ taps`` into
    (B, n_gb, W) windows, then the windows' overlapping g-wide pieces folded
    into the (B, nsample) response."""
    half = tw // 2
    g = block if (block > 0 and tw % block == 0 and block % 2 == 0) else tw
    W = g + tw  # window width: tw active taps at an offset < g
    f_over = W // g  # g-wide pieces per window
    PAD = tw  # padded-domain shift: start_p >= 0 for any dist >= 0

    # Each chunk's static block range from its sorted distance bounds: its
    # images touch only blocks [base_c, base_c + K).
    def blk_of(d):
        return (np.floor(d) - half + 1 + PAD) // g

    base_blk = blk_of(lbc.min(axis=1)).astype(np.int64)
    K = int((blk_of(ubc.max(axis=1)) - base_blk).max() + 1)
    n_gb = int(blk_of(float(nsample - 1)) + K + f_over + 2)

    # Taps sit at integer positions p: with the window-local e = d - (blk g - PAD)
    # and t = n - e, sin(pi t) = -(-1)^n sin(pi e) and cos(2 pi t / Tw) =
    # cos(2 pi n / Tw) cos(2 pi e / Tw) + sin(2 pi n / Tw) sin(2 pi e / Tw), so the
    # three transcendentals are taken once per image, of e mod Tw in [0, Tw).
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n_rel_f = np.arange(W, dtype=np_dtype)
    tap_c = torch.from_numpy(np.cos(2.0 * np.pi * n_rel_f / tw)).to(device)
    tap_s = torch.from_numpy(np.sin(2.0 * np.pi * n_rel_f / tw)).to(device)
    tap_parity = torch.from_numpy(np.where(np.arange(W) % 2 == 0, 1.0, -1.0).astype(np_dtype)).to(device)
    n_rel = torch.arange(W, dtype=torch.int32, device=device)

    acc = torch.zeros(batch, n_gb, W, dtype=dtype, device=device)
    for img, base in zip(images, base_blk.tolist()):
        dist, gain = image_gains(img)
        fdist = torch.floor(dist)
        start_p = fdist.to(torch.int32) - half + 1 + PAD
        blk = torch.div(start_p, g, rounding_mode="floor")  # (B, chunk)
        off = (start_p - blk * g)[..., None]  # in [0, g)
        p_abs = blk[..., None] * g + n_rel - PAD  # unpadded index (B, chunk, W)
        t = p_abs.to(dtype) - dist[..., None]
        active = (n_rel >= off) & (n_rel < off + tw)
        frac = dist - fdist
        e = dist - (blk * g - PAD).to(dtype)
        emod = e - tw * torch.floor(e / tw)
        fd_parity = (1.0 - 2.0 * torch.remainder(fdist, 2.0))[..., None]
        cos_e = torch.cos(2.0 * math.pi * emod / tw)[..., None]
        sin_e = torch.sin(2.0 * math.pi * emod / tw)[..., None]
        sin_pe = fd_parity * torch.sin(math.pi * frac)[..., None]  # == sin(pi e)
        window = 0.5 * (1.0 + tap_c * cos_e + tap_s * sin_e)  # == 0.5 (1 + cos(2 pi t / Tw))
        sin_pt = -tap_parity * sin_pe  # == sin(pi t)
        sinc = torch.where(t == 0.0, 1.0, sin_pt / (math.pi * t + 1e-30))
        vals = torch.where(active, gain[..., None] * window * sinc, 0.0)  # (B, chunk, W)
        # K-local block sum; padding rows (gain 0) may clip out of the range
        loc = torch.clamp(blk - base, 0, K - 1)
        onehot = F.one_hot(loc.long(), K).to(dtype)  # (B, chunk, K)
        # Without the cull a chunk can lie wholly beyond the window (all its
        # gains 0): its range is clamped into the buffer, as JAX's
        # dynamic_update_slice clamps it.
        at = min(base, n_gb - K)
        acc[:, at : at + K] += torch.bmm(onehot.transpose(1, 2), vals)
    # fold the f_over overlapping g-wide pieces of every window:
    # padded[(b + q) g + j] += acc[b, q g + j]
    pieces = acc.reshape(batch, n_gb, f_over, g)
    folded = torch.zeros(batch, n_gb + f_over - 1, g, dtype=dtype, device=device)
    for q in range(f_over):
        folded[:, q : q + n_gb] += pieces[:, :, q]
    return folded.reshape(batch, -1)[:, PAD : PAD + nsample]


def generate_rir(source: torch.Tensor, receiver, **kwargs) -> torch.Tensor:
    """One RIR of a (3,) source position: :func:`generate_rir_batch` of a
    batch of one; returns (nsample,). ``beta_traced`` is a scalar or (6,)."""
    return generate_rir_batch(source[None], receiver, **kwargs)[0]
