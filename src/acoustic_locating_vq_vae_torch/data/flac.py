"""Minimal pure-Python FLAC decoder (RFC 9639 subset), the built-in
fallback behind :func:`.speech.load_librispeech`.

The port's own copy of ``acoustic_locating_vq_vae_tpu/data/flac.py`` (numpy
only, no JAX), so that the port imports nothing of the JAX package. The
reference's speech corpus is LibriSpeech FLAC decoded through torchaudio
(genereate_dataset.py:93); an installation without torchaudio, soundfile or
a ``flac`` binary still decodes it here. This module implements the subset
every libFLAC-encoded LibriSpeech file uses: 16-bit PCM,
constant/verbatim/fixed/LPC subframes, Rice-coded residuals with
partitioning and escape codes, all stereo channel assignments, frame-header
CRC-8 and frame CRC-16 verification, in plain Python. It is a correctness
fallback, not a throughput path: ``load_librispeech`` prefers soundfile
where it imports and only falls back here.

Layout notes (RFC 9639 §9): a stream is ``fLaC`` + metadata blocks
(STREAMINFO first) + frames. Each frame: 14-bit sync ``0b11111111111110``,
reserved bit, blocking-strategy bit, 4-bit block-size code, 4-bit
sample-rate code, 4-bit channel assignment, 3-bit bit-depth code, reserved
bit, UTF-8-coded frame/sample number, optional block-size / sample-rate
tails, CRC-8. Then one subframe per channel (stereo decorrelation modes
widen one channel by 1 bit), bit padding to a byte boundary, CRC-16.
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np

__all__ = ["decode_flac", "read_flac"]


class _BitReader:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits  # absolute bit position

    def read_uint(self, n: int) -> int:
        if n == 0:
            return 0
        pos, data = self.pos, self.data
        end = pos + n
        if end > 8 * len(data):
            raise ValueError("FLAC bitstream truncated")
        first, last = pos >> 3, (end + 7) >> 3
        chunk = int.from_bytes(data[first:last], "big")
        chunk >>= (8 * (last - first)) - (end - (first << 3))
        self.pos = end
        return chunk & ((1 << n) - 1)

    def read_int(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count 0-bits up to the terminating 1-bit (Rice quotient)."""
        data, pos = self.data, self.pos
        n = 0
        nbits = 8 * len(data)
        # Fast path: scan whole zero bytes when aligned enough.
        while True:
            if pos >= nbits:
                raise ValueError("FLAC bitstream truncated in unary code")
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            window = byte & ((1 << rem) - 1)
            if window == 0:
                n += rem
                pos += rem
                continue
            lead = rem - window.bit_length()
            n += lead
            pos += lead + 1  # consume the terminating 1
            self.pos = pos
            return n

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _read_utf8_coded(r: _BitReader) -> int:
    """The frame header's UTF-8-style variable-length number (RFC 9639
    §9.1.5; up to 36 bits, i.e. 7 bytes)."""
    first = r.read_uint(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra < 1 or n_extra > 6:
        raise ValueError(f"invalid UTF-8-coded number lead byte {first:#x}")
    val = first & (mask - 1)
    for _ in range(n_extra):
        b = r.read_uint(8)
        if b >> 6 != 0b10:
            raise ValueError("invalid UTF-8-coded continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val


_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
    8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_BIT_DEPTHS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# Fixed-predictor coefficients by order (RFC 9639 §9.2.2): s[i] is predicted
# from the previous ``order`` samples with these weights.
_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(r: _BitReader, block_size: int, pred_order: int) -> List[int]:
    method = r.read_uint(2)
    if method not in (0, 1):
        raise ValueError(f"reserved residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = r.read_uint(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("partition count does not divide block size")
    out: List[int] = []
    for p in range(n_parts):
        count = (block_size >> part_order) - (pred_order if p == 0 else 0)
        if count < 0:
            raise ValueError("predictor order exceeds first partition")
        param = r.read_uint(param_bits)
        if param == escape:
            raw = r.read_uint(5)
            if raw == 0:
                out.extend([0] * count)
            else:
                out.extend(r.read_int(raw) for _ in range(count))
        else:
            for _ in range(count):
                q = r.read_unary()
                v = (q << param) | r.read_uint(param)
                out.append((v >> 1) ^ -(v & 1))  # zigzag -> signed
    return out


def _decode_subframe(r: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if r.read_uint(1):
        raise ValueError("subframe padding bit is 1")
    sf_type = r.read_uint(6)
    wasted = 0
    if r.read_uint(1):  # wasted-bits-per-sample flag: unary count - 1
        wasted = r.read_unary() + 1
    eff_bps = bps - wasted

    if sf_type == 0:  # CONSTANT
        samples = np.full(block_size, r.read_int(eff_bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = np.fromiter(
            (r.read_int(eff_bps) for _ in range(block_size)), np.int64, block_size
        )
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        warm = [r.read_int(eff_bps) for _ in range(order)]
        res = _decode_residual(r, block_size, order)
        coef = _FIXED_COEFFS[order]
        s = list(warm)
        for i in range(order, block_size):
            pred = sum(c * s[i - 1 - j] for j, c in enumerate(coef))
            s.append(pred + res[i - order])
        samples = np.asarray(s, np.int64)
    elif sf_type >= 32:  # LPC, order 1-32
        order = (sf_type & 0x1F) + 1
        warm = [r.read_int(eff_bps) for _ in range(order)]
        prec = r.read_uint(4)
        if prec == 0xF:
            raise ValueError("invalid LPC coefficient precision")
        prec += 1
        shift = r.read_int(5)
        if shift < 0:
            raise ValueError("negative LPC shift is reserved")
        coef = [r.read_int(prec) for _ in range(order)]
        res = _decode_residual(r, block_size, order)
        s = list(warm)
        for i in range(order, block_size):
            pred = sum(c * s[i - 1 - j] for j, c in enumerate(coef)) >> shift
            s.append(pred + res[i - order])
        samples = np.asarray(s, np.int64)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    return samples << wasted


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream. Returns ``(samples, sample_rate)`` with samples
    float32 in [-1, 1), shape (n,) mono or (n, channels)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    streaminfo = None
    while True:
        header = data[pos : pos + 4]
        if len(header) < 4:
            raise ValueError("truncated metadata block header")
        last = header[0] >> 7
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            if len(body) < 34:
                raise ValueError("short STREAMINFO")
            bits = int.from_bytes(body[10:18], "big")
            streaminfo = {
                "sample_rate": (bits >> 44) & 0xFFFFF,
                "channels": ((bits >> 41) & 0x7) + 1,
                "bps": ((bits >> 36) & 0x1F) + 1,
                "total_samples": bits & 0xFFFFFFFFF,
            }
        pos += 4 + length
        if last:
            break
    if streaminfo is None:
        raise ValueError("no STREAMINFO block")
    sr = streaminfo["sample_rate"]
    n_ch = streaminfo["channels"]

    chans: List[List[int]] = [[] for _ in range(n_ch)]
    total = 0
    r = _BitReader(data, pos * 8)
    nbits = len(data) * 8
    while r.pos + 16 <= nbits:
        frame_start_byte = r.pos >> 3
        sync = r.read_uint(14)
        if sync != 0b11111111111110:
            raise ValueError(f"lost frame sync at byte {frame_start_byte}")
        if r.read_uint(1):
            raise ValueError("reserved frame header bit set")
        r.read_uint(1)  # blocking strategy
        bs_code = r.read_uint(4)
        sr_code = r.read_uint(4)
        ch_code = r.read_uint(4)
        bd_code = r.read_uint(3)
        if r.read_uint(1):
            raise ValueError("reserved frame header bit set")
        _read_utf8_coded(r)
        if bs_code in _BLOCK_SIZES:
            block_size = _BLOCK_SIZES[bs_code]
        elif bs_code == 6:
            block_size = r.read_uint(8) + 1
        elif bs_code == 7:
            block_size = r.read_uint(16) + 1
        else:
            raise ValueError(f"reserved block size code {bs_code}")
        if sr_code == 0 or sr_code in _SAMPLE_RATES:
            pass  # streaminfo rate / table rate — we use streaminfo's
        elif sr_code == 12:
            r.read_uint(8)
        elif sr_code in (13, 14):
            r.read_uint(16)
        else:
            raise ValueError(f"invalid sample rate code {sr_code}")
        bps = streaminfo["bps"] if bd_code == 0 else _BIT_DEPTHS.get(bd_code)
        if bps is None:
            raise ValueError(f"reserved bit depth code {bd_code}")
        r.align_byte()  # CRC-8 sits at a byte boundary by construction
        header_end = r.pos >> 3
        if _crc8(data[frame_start_byte : header_end]) != data[header_end]:
            raise ValueError("frame header CRC-8 mismatch")
        r.read_uint(8)  # the CRC byte itself

        if ch_code < 8:
            if ch_code + 1 != n_ch:
                raise ValueError("frame/streaminfo channel count mismatch")
            subs = [_decode_subframe(r, block_size, bps) for _ in range(n_ch)]
        elif ch_code in (8, 9, 10):  # stereo decorrelation modes
            if n_ch != 2:
                raise ValueError("decorrelated frame in non-stereo stream")
            if ch_code == 8:  # left/side
                left = _decode_subframe(r, block_size, bps)
                side = _decode_subframe(r, block_size, bps + 1)
                subs = [left, left - side]
            elif ch_code == 9:  # right/side
                side = _decode_subframe(r, block_size, bps + 1)
                right = _decode_subframe(r, block_size, bps)
                subs = [right + side, right]
            else:  # mid/side
                mid = _decode_subframe(r, block_size, bps)
                side = _decode_subframe(r, block_size, bps + 1)
                left = ((mid << 1) | (side & 1)) + side >> 1
                subs = [left, left - side]
        else:
            raise ValueError(f"reserved channel assignment {ch_code}")

        r.align_byte()
        body_end = r.pos >> 3
        want = int.from_bytes(data[body_end : body_end + 2], "big")
        if _crc16(data[frame_start_byte:body_end]) != want:
            raise ValueError("frame CRC-16 mismatch")
        r.read_uint(16)
        for c in range(n_ch):
            chans[c].extend(subs[c].tolist())
        total += block_size
        if streaminfo["total_samples"] and total >= streaminfo["total_samples"]:
            break

    n = streaminfo["total_samples"] or total
    arr = np.asarray(chans, np.float64)[:, :n] / float(1 << (streaminfo["bps"] - 1))
    out = arr.astype(np.float32)
    return (out[0] if n_ch == 1 else out.T), sr


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """File-path convenience wrapper over :func:`decode_flac` (the same
    ``(data, sample_rate)`` contract as ``soundfile.read``)."""
    with open(path, "rb") as f:
        return decode_flac(f.read())
