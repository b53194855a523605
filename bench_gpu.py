#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one NVIDIA card. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "card": ..., ...}

    python3 bench_gpu.py                 # on the card
    python3 bench_gpu.py --device cpu --width-scale 0.03125 --batch 4 --steps 2 --windows 1

The port's counterpart of ``bench.py`` (which stays the JAX package's), with
its keys. Headline: spectrogram frames/s of the echoed-speech training step
from the frozen-latent cache (``Trainer(cache_frozen=True)``) at the
reference geometry, B = 64, 201 x 500, FP32 with TF32 off (the trainer's
``full_fp32``). Secondary fields: the uncached step (the reference's
semantics, both encoders recomputed), the bf16 cached step
(``compute_dtype="bfloat16"``) and ``fp32_peak_share``: bench.py's analytic
FLOP count of the step (``echoed_step_model_tflops``, copied below) over the
card's dense FP32 peak.

Each step samples its batch from a resident set of seeded random power
spectrograms (the step's time does not depend on their values), and each
time is the best of ``--windows`` windows of ``--steps`` steps, each window
ending in a synchronisation, after three warm-up steps (bench.py: best of
five ten-step windows). ``vs_baseline`` is the ratio to bench.py's recorded
throughput of the reference's torch training step on a CPU, 734.6 frames/s
(``REFERENCE_CPU_FRAMES_PER_SEC``, measured by scripts/bench_reference_cpu.py,
BASELINE.md). ``card`` is ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# bench.py's recorded frames/s of the reference's echoed-speech training step on a CPU (BASELINE.md)
REFERENCE_CPU_FRAMES_PER_SEC = 734.6
BASELINE_SOURCE = "bench.py REFERENCE_CPU_FRAMES_PER_SEC (scripts/bench_reference_cpu.py, BASELINE.md)"
# NVIDIA H100 SXM dense FP32 peak, TFLOP/s: the denominator of fp32_peak_share
H100_FP32_PEAK_TFLOPS = 67.0


def _conv_flops(b, l, cin, cout, k):  # one Conv1d, stride 1, length-preserving
    return 2.0 * b * l * cin * cout * k


def echoed_step_model_tflops(cfg, batch_size: int, cached: bool = False, width_scale: float = 1.0) -> float:
    """Analytic model FLOPs of one echoed-speech training step (bench.py's
    count, train_echoed_speech.py:21-31): the frozen speech and RIR encoder
    forwards plus the trained composite decoder at 3x its forward; conv and
    matmul terms only. ``cached`` counts the decoder alone (the cache
    replaces both encoders by codebook gathers). ``width_scale`` scales the
    widths as the tasks do (1.0: bench.py's count)."""
    s = lambda v: max(4, int(v * width_scale))
    B, F, T = batch_size, cfg.num_freq, cfg.num_frames
    H, K = s(1024), s(1024)

    def encoder(l, cin, d, rh, layers):
        f = _conv_flops(B, l, cin, H, 3)  # enc conv_1
        f += layers * (_conv_flops(B, l, H, rh, 3) + _conv_flops(B, l, rh, H, 1))
        f += _conv_flops(B, l, H, d, 3)  # pre_vq
        f += 2.0 * (B * l) * d * K  # VQ distance cross-term matmul
        return f

    speech = encoder(T, F, s(128), s(1024), 3)
    rir = encoder(F, T, s(64), s(64), 2)

    dec_in = s(128) + s(64)
    dec = _conv_flops(B, T, dec_in, H, 3)
    dec += 2 * (_conv_flops(B, T, H, s(1024), 3) + _conv_flops(B, T, s(1024), H, 1))
    dec += 2 * _conv_flops(B, T, H, H, 3) + _conv_flops(B, T, H, F, 3)

    if cached:
        return (3.0 * dec) / 1e12
    return (speech + rir + 3.0 * dec) / 1e12


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[device.index or 0]


def best_window_s(step, device, steps: int, windows: int) -> float:
    """Seconds per step: the best of ``windows`` windows of ``steps`` calls
    of ``step``, each window between two synchronisations, after three
    warm-up calls."""
    import torch

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    for _ in range(3):
        step()
    sync()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--width-scale", type=float, default=1.0, help="model widths relative to the published model")
    p.add_argument("--batch", type=int, default=64, help="the echoed stage's batch (64)")
    p.add_argument("--rows", type=int, default=128, help="rows of the resident set the steps sample from")
    p.add_argument("--steps", type=int, default=10, help="steps per timed window")
    p.add_argument("--windows", type=int, default=5, help="timed windows; the best one counts")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
    from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, Trainer
    from acoustic_locating_vq_vae_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = DatasetConfig()  # the reference geometry: 201 x 500
    g = torch.Generator(device=device).manual_seed(args.seed)
    n, f, t = args.rows, cfg.num_freq, cfg.num_frames
    spec = lambda: torch.empty(n, f, t, device=device).exponential_(generator=g)
    data = SampleBatch(speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(),
                       fs=torch.full((n,), cfg.fs, device=device), theta=torch.rand(n, generator=g, device=device),
                       wiener_est=torch.rand(n, f, generator=g, device=device), radius=torch.ones(n, device=device))

    def timed(compute_dtype: str, cached: bool, weights=None):
        task = EchoedSpeechTask(config=cfg, width_scale=args.width_scale, batch_size=args.batch,
                                compute_dtype=compute_dtype)
        trainer = Trainer(task, device=device, seed=args.seed + 1, verbose=False, cache_frozen=cached)
        if weights is not None:
            trainer.model.load_state_dict(weights)
        if cached:
            cache = trainer.build_cache(data)
            step = lambda: _cached_step(trainer, data, cache)
        else:
            step = lambda: trainer.step(trainer.sample(data))
        return best_window_s(step, device, args.steps, args.windows), trainer.model.state_dict()

    dt_full, weights = timed("float32", False)
    dt_cached, _ = timed("float32", True, weights)
    dt_bf16, _ = timed("bfloat16", True, weights)

    frames = lambda dt: args.batch * cfg.num_frames / dt
    tflops = lambda cached: echoed_step_model_tflops(cfg, args.batch, cached, args.width_scale)
    out = {
        "metric": "echoed_speech_train_frames_per_sec_per_card",
        "value": round(frames(dt_cached), 1),
        "unit": "frames/s",
        "vs_baseline": round(frames(dt_cached) / REFERENCE_CPU_FRAMES_PER_SEC, 4),
        "baseline_source": BASELINE_SOURCE,
        "card": card_name(device),
        "batch": args.batch,
        "width_scale": args.width_scale,
        "model_tflops_per_step": round(tflops(True), 6),
        "model_tflops_per_sec": round(tflops(True) / dt_cached, 3),
        "fp32_peak_share": round(tflops(True) / dt_cached / H100_FP32_PEAK_TFLOPS, 4),
        "cached_step_ms": round(dt_cached * 1e3, 4),
        "uncached_frames_per_sec": round(frames(dt_full), 1),
        "uncached_vs_baseline": round(frames(dt_full) / REFERENCE_CPU_FRAMES_PER_SEC, 4),
        "uncached_step_ms": round(dt_full * 1e3, 4),
        "uncached_model_tflops_per_step": round(tflops(False), 6),
        "uncached_fp32_peak_share": round(tflops(False) / dt_full / H100_FP32_PEAK_TFLOPS, 4),
        "bf16_cached_frames_per_sec": round(frames(dt_bf16), 1),
        "bf16_cached_step_ms": round(dt_bf16 * 1e3, 4),
    }
    print(json.dumps(out), flush=True)
    return out


def _cached_step(trainer, data, cache):
    batch, rows = trainer.sample_cached(data, cache)
    return trainer.step(batch, cache=rows)


if __name__ == "__main__":
    main()
