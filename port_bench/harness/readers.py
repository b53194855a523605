"""The arithmetic of the metric readers (``metrics/<name>.py``): each
reader calls one of these on the run, with what it attributes time by (its
kernel-name pattern or host operations), which lives in the reader. A
reading that has nothing to read is None, never 0."""

from __future__ import annotations

from .flops import PEAK_FP32_FLOPS, vq_nearest_bound_s
from .trace import device_s_under, kernel_time
from .window import p95


def frames_per_s(run):
    """Spectrogram frames (B x num_frames) of every whole step of the window
    over its seconds."""
    w = run["window"]
    return w["steps"] * run["batch"] * run["frames"] / w["seconds"] if w["steps"] else None


def samples_per_s(run):
    """Samples of every call of the window over its seconds."""
    w = run["window"]
    return w["steps"] * run["batch"] / w["seconds"] if w["steps"] else None


def p95_ms(run):
    """The 95th percentile of every call of the window, in ms."""
    v = p95(run["window"]["latencies"])
    return None if v is None else v * 1e3


def mfu(run):
    """The step's or call's model FLOPs times the window's steps, over its
    seconds, as a share of the FP32 peak."""
    w = run["window"]
    return 100.0 * run["counts"]["model"] * w["steps"] / w["seconds"] / PEAK_FP32_FLOPS if w["steps"] else None


def conv_roofline(run, ops):
    """The conv FLOPs of the traced steps over the device time of the kernels
    launched under the host operations ``ops`` (the conv operators), as a
    share of the FP32 peak."""
    t = run.get("trace")
    conv_s = device_s_under(t, ops) if t else 0.0
    if not conv_s:
        return None
    return 100.0 * run["counts"]["conv"] * t["steps"] / conv_s / PEAK_FP32_FLOPS


def vq_nearest_roofline(run, kernel):
    """The least time of the traced assignment calls over the device time of
    the kernels whose name holds ``kernel``; None where the launches are not
    the shapes' (another kernel, or other work)."""
    t = run.get("trace")
    calls = run["counts"]["vq_calls"]
    if not t or not calls:
        return None
    vq_s, launches = kernel_time(t, kernel)
    if not vq_s or launches != len(calls) * t["steps"]:
        return None
    return 100.0 * sum(vq_nearest_bound_s(*c) for c in calls) * t["steps"] / vq_s


def device_idle(run):
    """The traced window's share in which no operation ran on the card."""
    t = run.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t.get("window_s") and t.get("busy_s") else None


def share_under(run, ops):
    """The device time of the kernels launched under the host operations
    ``ops`` (a span of the program's or the benchmark's), as a share of the
    traced window's busy time."""
    t = run.get("trace")
    under = device_s_under(t, ops) if t else 0.0
    return 100.0 * under / t["busy_s"] if under and t.get("busy_s") else None
