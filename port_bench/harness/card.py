"""What ``nvidia-smi`` says of the card: its name and power limit, and its
SM clock, power draw and temperature, read before and after a window (never
during one: the read is a process of its own)."""

from __future__ import annotations

import subprocess
from typing import Dict, List

import torch

QUERY = "clocks.sm,power.draw,temperature.gpu,power.limit"


def _smi(query: str, index: int) -> List[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        return [v.strip() for v in out[index].split(",")]
    except (OSError, subprocess.SubprocessError, IndexError):
        return []


def device_info(device: torch.device) -> Dict[str, str]:
    """``platform``, ``kind`` (``torch.cuda.get_device_name``) and the power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": "none"}
    got = _smi("power.limit", device.index or 0)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "power_limit": (got[0] + " W") if got else "unknown"}


def sample(device: torch.device) -> Dict[str, str]:
    """The card's SM clock (MHz), power draw (W), temperature (C) and power limit (W) now."""
    if device.type != "cuda":
        return {}
    return dict(zip(("sm_mhz", "power_w", "temp_c", "limit_w"), _smi(QUERY, device.index or 0)))
