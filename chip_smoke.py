#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it against itself.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; builds the
port's kernels from ``src/acoustic_locating_vq_vae_torch/csrc`` first. Imports
nothing of JAX. Phases, one line each (more for detail):

1. device and build: the card's name and power limit (nvidia-smi), and the
   build of every kernel, one nvcc per source, all started together;
2. kernel vs plain on the card: the nearest-codebook kernel against the plain
   PyTorch version at serving shapes, ragged shapes and all-ties;
3. the slice at full width: the joint localizer (sincos + radius, vectors
   flatten) and the frozen localizer (one-hot encodings, memory-order
   flatten) with seeded random weights serve a seeded batch on the card and
   on the CPU; launch counts show the serving run went through the kernel;
4. timings on the card: median serve latency at B = 8 and B = 64, and the
   kernel beside its bound, its plain version and a one-call library yardstick.

Then a JSON line of per-kernel numbers and, last, ``{"ok": true, "device":
...}``. Any failure raises, and the exit code is not 0.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
# H100 SXM data sheet: FP32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TIE_RTOL = 1e-6  # code mismatches allowed only where the scores tie to this
MAX_MISMATCH_SHARE = 1e-3
ATOL = 1e-4
SERVE_B = 64
N_SERVE = SERVE_B * 201


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


def check_codes(x, codebook, got, want, label: str):
    """Rows where ``got`` and ``want`` pick different codes must tie in
    float64 to TIE_RTOL * (||x||^2 + ||e||^2), and be at most
    MAX_MISMATCH_SHARE of the rows. Returns (mismatches, max score gap)."""
    import torch

    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    x64 = x[rows].double()
    cb64 = codebook.double()
    e_got, e_want = cb64[got[rows]], cb64[want[rows]]
    gap = (((x64 - e_got) ** 2).sum(1) - ((x64 - e_want) ** 2).sum(1)).abs()
    scale = (x64**2).sum(1) + torch.maximum((e_got**2).sum(1), (e_want**2).sum(1))
    bad = int((gap > TIE_RTOL * scale).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} rows pick a code that is not a tie")
    if rows.numel() > MAX_MISMATCH_SHARE * got.numel():
        raise AssertionError(f"{label}: {rows.numel()} of {got.numel()} rows differ on ties")
    return int(rows.numel()), float(gap.max())


def event_ms(fn, iters: int = 50) -> float:
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def serve_latency_ms(serve, inputs) -> float:
    """Median host-clock time of one serve call, barrier before and after,
    over distinct inputs already on the card, after warm-up."""
    import torch

    for x in inputs[:3]:
        serve(x)
    times = []
    for x in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_breakdown(serve, inputs, top: int = 6):
    """Kernel time by name over serve calls (torch.profiler), and the host
    clock of the profiled window. Returns (wall_us, busy_us, top kernels as
    (name, launches, device_us)); busy_us is 0 if the profiler saw no device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    serve(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            serve(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    on_card.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in on_card)
    return wall_us, busy_us, [(e.key, e.count, e.self_device_time_total) for e in on_card[:top]]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from acoustic_locating_vq_vae_torch.data import DatasetConfig
    from acoustic_locating_vq_vae_torch.dsp import znorm
    from acoustic_locating_vq_vae_torch.eval import full_fp32, make_serving_fn
    from acoustic_locating_vq_vae_torch.ops import kernels, vq
    from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda
    from acoustic_locating_vq_vae_torch.train import JointLocationTask, LocationTask

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{kind}, power limit {smi.split(',')[-1].strip()}"
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    for source in kernels.SOURCES:
        kernels.library(source)  # loads, and fails here if the build did not
    phase(1, f"device {kind} (nvidia-smi: {smi}); built {list(logs) or 'nothing, all cached'} "
             f"of {list(kernels.SOURCES)} in {build_s:.2f} s")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: {line.strip()}", flush=True)

    # ---- phase 2: kernel vs plain on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    report = []
    with full_fp32():
        for n, d, k in [(N_SERVE, 64, 1024), (8 * 201, 64, 1024), (100, 4, 16), (513, 128, 100)]:
            x = torch.randn(n, d, generator=gen, device=dev)
            cb = torch.randn(k, d, generator=gen, device=dev)
            e2 = (cb * cb).sum(1)
            got = nearest_indices_cuda(x, cb, e2).long()
            want = vq.nearest_indices(x, cb, e2)
            torch.cuda.synchronize()
            mism, gap = check_codes(x, cb, got, want, f"kernel ({n}, {d}, {k})")
            max_err = max(max_err, gap)
            report.append(f"({n},{d},{k}): {mism} tie rows differ")
        ties = nearest_indices_cuda(torch.ones(8, 4, device=dev), torch.ones(6, 4, device=dev), torch.full((6,), 4.0, device=dev))
        if not torch.equal(ties.cpu(), torch.zeros(8, dtype=torch.int32)):
            raise AssertionError(f"all-ties rows must take code 0, got {ties.tolist()}")
    phase(2, f"kernel == plain at {'; '.join(report)}; all-ties -> first index; "
             f"max float64 score gap on differing rows {max_err}")

    # ---- phase 3: the slice at full width, card vs CPU
    cfg = DatasetConfig()
    g = torch.Generator().manual_seed(1234)

    def specs(b, n=1):
        """Seeded echoed power spectrograms (non-negative, heavy-tailed)."""
        return [torch.empty(b, cfg.num_freq, cfg.num_frames).exponential_(generator=g) for _ in range(n)]

    def flat_latent(rir, spec):
        x = znorm(spec, dim=1).transpose(1, 2)
        z = rir.pre_vq_latent(x)
        return (z if rir.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, rir.embedding_dim)

    joint_task = JointLocationTask(predict_radius=True)
    frozen_task = LocationTask()
    joint = joint_task.build_model(g)
    head, rir = frozen_task.build_model(g), frozen_task.build_rir_model(g)
    # An untrained U(+-1/K) codebook makes the argmin a near-tie lottery:
    # use K pre-VQ latent rows of a separate seeded batch instead.
    with torch.no_grad(), full_fp32():
        for branch in (joint.rir_model, rir):
            rows = flat_latent(branch, specs(8)[0])
            pick = torch.randperm(rows.shape[0], generator=g)[: branch.num_embeddings]
            branch._vq._embedding.weight.copy_(rows[pick])
    paths = {
        "joint": (joint_task, joint.state_dict(), None, joint.rir_model),
        "frozen": (frozen_task, head.state_dict(), rir.state_dict(), rir),
    }
    spec = specs(8)[0]
    launches = {}
    outs = {}
    for name, (task, params, comp, branch) in paths.items():
        serve_gpu = make_serving_fn(task, params, cfg, comp, device=dev)
        serve_cpu = make_serving_fn(task, params, cfg, comp, device="cpu")
        spec_gpu = spec.to(dev)
        torch.cuda.synchronize()
        nearest_indices_cuda.launches = 0
        out_gpu = serve_gpu(spec_gpu)
        torch.cuda.synchronize()
        launches[name] = nearest_indices_cuda.launches
        if launches[name] < 1:
            raise AssertionError(f"{name} serving never launched the vq_nearest kernel")
        out_cpu = serve_cpu(spec)
        outs[name] = (serve_gpu, serve_cpu)

        with torch.inference_mode(), full_fp32():
            x_cpu = znorm(spec, dim=1).transpose(1, 2)
            codes_cpu = branch.get_latent_codes(x_cpu)
            branch_gpu = copy.deepcopy(branch).to(dev)
            codes_gpu = branch_gpu.get_latent_codes(x_cpu.to(dev)).cpu()
            mism, gap = check_codes(
                flat_latent(branch, spec), branch._vq._embedding.weight, codes_gpu.flatten(),
                codes_cpu.flatten(), f"{name} codes card vs CPU",
            )
            del branch_gpu
        theta, radius, coords = (t.cpu() for t in out_gpu)
        for t, shape in ((theta, (8,)), (radius, (8,)), (coords, (8, 3))):
            if t.shape != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: output of shape {tuple(t.shape)}, want {shape}, all finite")
        if bool((coords > torch.tensor(cfg.room_dimensions) + 1e-6).any()):
            raise AssertionError(f"{name}: coordinates outside the room")
        same = (codes_cpu == codes_gpu).all(1)
        dtheta = torch.remainder(theta - out_cpu[0] + math.pi, 2 * math.pi) - math.pi
        errs = {
            "theta": float(dtheta[same].abs().max()),
            "radius": float((radius - out_cpu[1])[same].abs().max()),
            "coords": float((coords - out_cpu[2])[same].abs().max()),
        }
        if int(same.sum()) < 1 or max(errs.values()) > ATOL:
            raise AssertionError(f"{name}: card vs CPU {errs} over {int(same.sum())} samples, atol {ATOL}")
        phase(3, f"{name} localizer at full width, B=8: kernel launches {launches[name]}; "
                 f"codes card vs CPU differ on {mism} tie rows (gap {gap}); "
                 f"{int(same.sum())}/8 samples with equal codes, max |card - CPU| {errs}")

    # ---- phase 4: timings on the card
    for name, (serve_gpu, _) in outs.items():
        lat = {}
        for b in (8, SERVE_B):
            inputs = [s.to(dev) for s in specs(b, 20)]
            lat[b] = serve_latency_ms(serve_gpu, inputs)
            del inputs
        phase(4, f"{name} serve latency, median of 20 distinct inputs on the card: "
                 f"B=8 {lat[8]:.4f} ms, B={SERVE_B} {lat[SERVE_B]:.4f} ms ({card})")
        for b in (8, SERVE_B):
            inputs = [s.to(dev) for s in specs(b, 5)]
            wall_us, busy_us, top = device_breakdown(serve_gpu, inputs)
            del inputs
            if busy_us == 0:
                phase(4, f"{name} B={b}: the profiler recorded no device time")
                continue
            tops = "; ".join(f"{k[:70]} x{c} {t / 5:.1f} us ({t / busy_us:.1%})" for k, c, t in top)
            phase(4, f"{name} B={b} profiled, per call: {wall_us / 5 / 1e3:.4f} ms host clock, "
                     f"card busy {busy_us / 5 / 1e3:.4f} ms ({busy_us / wall_us:.1%}); "
                     f"kernels by device time: {tops}")

    n, d, k = N_SERVE, 64, 1024
    x = torch.randn(n, d, generator=gen, device=dev)
    cb = torch.randn(k, d, generator=gen, device=dev)
    e2 = (cb * cb).sum(1)
    with full_fp32():
        launches_before = nearest_indices_cuda.launches
        kernel_ms = event_ms(lambda: nearest_indices_cuda(x, cb, e2))
        nearest_indices_cuda.launches = launches_before
        plain_ms = event_ms(lambda: vq.nearest_indices(x, cb, e2))
        library_ms = event_ms(lambda: torch.addmm(e2, x, cb.T, alpha=-2).argmin(1))
    flops = 2 * n * k * d
    nbytes = 4 * (n * d + k * d + k) + 4 * n
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    phase(4, f"vq_nearest at N={n}, D={d}, K={k}: kernel {kernel_ms:.5f} ms, bound {bound_ms:.5f} ms "
             f"({flops} FP32 ops, {nbytes} bytes), plain version {plain_ms:.5f} ms, "
             f"library addmm+argmin {library_ms:.5f} ms, all at TF32 off ({card})")

    print(json.dumps({"kernels": [{
        "name": "vq_nearest",
        "route": "cuda",
        "source": "src/acoustic_locating_vq_vae_torch/csrc/vq_nearest.cu",
        "replaces": "src/acoustic_locating_vq_vae_tpu/ops/vq_pallas.py:49",
        "launches": sum(launches.values()),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
