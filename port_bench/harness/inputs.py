"""The benchmark's one generator of resident inputs: seeded power
spectrograms made on the device, one large call a field.

A power spectrogram of the reference geometry is (num_freq, num_frames) =
(201, 500) non-negative values; an exponential draw stands for one (the
port's kernels and convolutions do the same work whatever the values). A
mix's ``fields`` names the ``SampleBatch`` fields held with rows, as the
program's datasets hold them (``make_dataset``: speech, RIR and echoed
spectrograms; the echoed stage reads the echoed one).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch


def spectrograms(gen: torch.Generator, rows: int, geometry: dict) -> torch.Tensor:
    """(rows, num_freq, num_frames) float32 seeded power spectrograms on the generator's device."""
    bins, frames = int(geometry["NFFT"]) // 2 + 1, int(geometry["num_frames"])
    return torch.empty(rows, bins, frames, device=gen.device).exponential_(generator=gen)


def resident(gen: torch.Generator, rows: int, geometry: dict, fields: Iterable[str]) -> Dict[str, torch.Tensor]:
    """A resident set: each field of ``fields`` as seeded spectrograms of
    ``rows`` rows, the others empty (rows, 0, 0), with labels: an angle
    U(-pi, pi), the geometry's radius, its sample rate and an exponential
    Wiener estimate per bin."""
    dev, fields = gen.device, set(fields)
    empty = torch.zeros(rows, 0, 0, device=dev)
    out = {f: (spectrograms(gen, rows, geometry) if f in fields else empty)
           for f in ("speech_spec", "rir_spec", "echoed_spec")}
    out["theta"] = -math.pi + 2 * math.pi * torch.rand(rows, generator=gen, device=dev)
    out["radius"] = torch.full((rows,), float(geometry["R"]), device=dev)
    out["fs"] = torch.full((rows,), int(geometry["fs"]), dtype=torch.int32, device=dev)
    bins = int(geometry["NFFT"]) // 2 + 1
    out["wiener_est"] = torch.empty(rows, bins, device=dev).exponential_(generator=gen)
    return out
