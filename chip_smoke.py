#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it against itself.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1, 2 and 5 and the kernels' timings only

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; builds the
port's kernels from ``src/acoustic_locating_vq_vae_torch/csrc`` first. Imports
nothing of JAX. Phases, one line each (more for detail):

1. device and build: the card's name and power limit (nvidia-smi), and the
   build of every kernel, one nvcc per source, all started together, with
   ptxas's registers, shared memory and spills per kernel;
2. kernel vs plain on the card: the nearest-codebook kernel against the plain
   PyTorch version at the serving shapes, the speech and RIR stages' training
   shapes and the shapes that reach each branch of the kernel (the codebook
   split over a cluster at N = 1,608, K off and below a code tile, D = 4,
   6, 129 and 256), two launches equal; exactly on duplicated codebook rows,
   +0.0 against -0.0 scores, a row of NaN and all ties;
3. the slice at full width: the joint localizer (sincos + radius, vectors
   flatten) and the frozen localizer (one-hot encodings, memory-order
   flatten) with seeded random weights serve a seeded batch on the card and
   on the CPU; launch counts show the serving run went through the kernel;
4. timings on the card: median serve latency at B = 8 and B = 64, the floor
   of one empty launch, and the kernel at N = 1,608 and 12,864 beside its
   bound, its plain version and a one-call library yardstick;
5. the codebook-accumulation kernel (codebook gradient and EMA statistics)
   against its plain version on the card at the speech, RIR, ragged and
   skewed shapes (one code and 32 codes in use, D = 4, 30 and 129, several
   scan rounds), and bitwise equal over two launches;
6. the training slice at full width: train steps of the speech VQ-VAE
   (gradient codebook at three seeds, EMA codebook at one) and of the RIR
   VQ-VAE (three seeds) at B = 4 on the card and on the CPU from the same
   seeded weights, batch and jitter decisions; codes, loss, metrics and the EMA
   buffers agree, every card gradient lies within GRAD_RTOL of the same step in
   float64, and a repeat of the card's step is bitwise equal; the gradients of
   control steps (cuDNN's default algorithms, TF32) are printed beside it;
   launch counts show the steps went through the kernels;
7. timings on the card: median train step and frames/s at B = 32 for both
   stages, a profiler breakdown of the speech step, yardstick steps with TF32
   allowed (speech) and with cuDNN's default algorithms (both stages), and each
   kernel at the speech and RIR shapes (the accumulation also with 32 codes
   and one code in use, and with a cold L2) beside its bound, its plain
   version and library yardsticks.

A kernel's time is read twice: on the card (some tens of calls captured in one
CUDA graph and replayed between two events, so no host work lies between the
launches) and as the enqueue time (two events around back-to-back Python
calls, which for a call of tens of microseconds is the host's launch rate).
The ``kernels`` line carries the card's time.

Then a JSON line of per-kernel numbers and, last, ``{"ok": true, "device":
...}``. Any failure raises, and the exit code is not 0.
"""

from __future__ import annotations

import contextlib
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
TRAIN_B = 32  # the stages' batch size
CHECK_B = 4  # the card-vs-CPU step (the CPU side costs ~0.4 TFLOP at full width)
SPEECH_N, SPEECH_D, SPEECH_K = TRAIN_B * 500, 128, 1024  # the speech stage's VQ rows
RIR_N = TRAIN_B * 201  # the RIR stage's VQ rows, D = 64, K = 1024
GRAD_SEEDS = (6, 60, 600)  # phase 6's gradient-mode steps; the EMA step uses the first
LOSS_RTOL = 1e-4
# Every gradient of the card's step must lie within GRAD_RTOL of its largest
# entry from the same step in float64 on the CPU. Set from phase 6's readings
# on the H100 (PERF.md): full-FP32 steps, on the card or on the CPU, read up
# to 5.9e-3 (the speech stage's gradients are ill-conditioned), TF32 steps
# 5.0e-2 to 0.17; 1e-2 passes the first and fails the second.
GRAD_RTOL = 1e-2
# of max(1, max |plain|), the plain version run in float64: the kernel sums
# FP32 rows in its own fixed order
ACCUM_RTOL = 1e-5
# `python3 chip_smoke.py --kernels` runs only what needs no model: the build,
# the kernels against their plain versions (phases 2 and 5) and their timings
# (of phases 4 and 7); a short run for working on a kernel
KERNELS_ONLY = "--kernels"


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
    """Enqueue time: two events around back-to-back Python calls. For a call
    of tens of microseconds this reads the host's launch rate, not the card."""
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


def graph_ms(fns, calls: int = 24, replays: int = 20) -> float:
    """The card's own time of one call: ``calls`` calls captured in one CUDA
    graph (no host work between the launches), the replays timed with events.
    ``fns`` is one callable or a list that the calls cycle through (distinct
    inputs that together exceed the L2 cache give a cold-cache reading)."""
    import torch

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    if not hasattr(graph_ms, "stream"):
        graph_ms.stream = torch.cuda.Stream()  # one for every capture: cuBLAS keeps a workspace per stream
    side = graph_ms.stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def profiled_ms(fn, calls: int = 24) -> float:
    """The card's own time of one call that cannot be captured in a graph
    (``torch.bincount`` reads its maximum back to the host): the profiler's
    device time of every kernel of ``calls`` calls, summed, over the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return busy_us / calls / 1e3


def both_ms(fn, capturable: bool = True):
    """(device ms, enqueue ms) of one call of ``fn``."""
    return (graph_ms(fn) if capturable else profiled_ms(fn)), event_ms(fn)


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


def accum_bound(n: int, d: int, k: int, counts: bool):
    """(bound ms, bound_by, ops, bytes) of one accumulation: each input read
    once, each output written once; one add per input element."""
    nbytes = 4 * (n * d + n + k * d + (k if counts else 0))
    ops = n * d + (n if counts else 0)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def nearest_bound(n: int, d: int, k: int):
    """(bound ms, bound_by, FP32 ops, bytes) of one nearest-codebook call."""
    flops = 2 * n * k * d
    nbytes = 4 * (n * d + k * d + k) + 4 * n
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def fmt_ms(pair) -> str:
    return f"{pair[0]:.5f} ms on the card ({pair[1]:.5f} enqueue)"


def time_nearest(ph: int, n: int, d: int, k: int, gen, card: str) -> dict:
    """vq_nearest, its plain version and addmm + argmin at one shape: device
    time (CUDA graph) and enqueue time (event loop), TF32 off."""
    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.ops import vq
    from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda

    x = torch.randn(n, d, generator=gen, device=gen.device)
    cb = torch.randn(k, d, generator=gen, device=gen.device)
    e2 = (cb * cb).sum(1)
    with full_fp32():
        kern = both_ms(lambda: nearest_indices_cuda(x, cb, e2))
        plain = both_ms(lambda: vq.nearest_indices(x, cb, e2))
        lib = both_ms(lambda: torch.addmm(e2, x, cb.T, alpha=-2).argmin(1))
    bound, by, flops, nbytes = nearest_bound(n, d, k)
    phase(ph, f"vq_nearest at N={n}, D={d}, K={k}: kernel {fmt_ms(kern)}; bound {bound:.5f} ms "
              f"({flops} FP32 ops, {nbytes} bytes); plain version {fmt_ms(plain)}; library addmm+argmin "
              f"{fmt_ms(lib)}; TF32 off ({card})")
    return dict(ms=kern[0], plain_ms=plain[0], bound_ms=bound, bound_by=by, library_ms=lib[0])


def accum_indices(kind: str, n: int, k: int, gen):
    """int32 code ids: ``uniform`` over K, ``32 codes`` in use, or ``one code``."""
    import torch

    if kind == "uniform":
        return torch.randint(0, k, (n,), generator=gen, device=gen.device, dtype=torch.int32)
    if kind == "32 codes":
        used = torch.randperm(k, generator=gen, device=gen.device)[:32].to(torch.int32)
        return used[torch.randint(0, 32, (n,), generator=gen, device=gen.device)]
    return torch.full((n,), k // 2, dtype=torch.int32, device=gen.device)


def time_accum(ph: int, n: int, d: int, k: int, kind: str, gen, card: str, extras: bool = False) -> dict:
    """Both modes of the accumulation kernel, their plain versions and one
    ``index_add_`` on ``kind`` indices: device and enqueue time. With
    ``extras`` also the one-hot GEMM and cold-cache readings (eight input
    sets in turn, 66 MB at the speech shape against 50 MB of L2)."""
    import torch
    import torch.nn.functional as F
    from acoustic_locating_vq_vae_torch.ops import vq
    from acoustic_locating_vq_vae_torch.ops.vq_cuda import codebook_grad_cuda, codebook_stats_cuda

    dev = gen.device
    x = torch.randn(n, d, generator=gen, device=dev)
    idx = accum_indices(kind, n, k, gen)
    idx64 = idx.long()
    out = {}
    lib = both_ms(lambda: torch.zeros(k, d, device=dev).index_add_(0, idx64, x))
    for name, fn, plain, counts in (
        ("vq_codebook_grad", lambda: codebook_grad_cuda(idx, x, k), lambda: vq.codebook_grad_plain(idx, x, k), False),
        ("vq_codebook_stats", lambda: codebook_stats_cuda(idx, x, k), lambda: vq.codebook_stats_plain(idx, x, k), True),
    ):
        kern = both_ms(fn)
        # bincount reads its maximum back to the host, which a graph cannot capture
        pl = both_ms(plain, capturable=not counts)
        bnd, by, ops, nb = accum_bound(n, d, k, counts)
        out[name] = dict(ms=kern[0], plain_ms=pl[0], library_ms=lib[0], bound_ms=bnd, bound_by=by)
        phase(ph, f"{name} at N={n}, D={d}, K={k}, {kind} indices: kernel {fmt_ms(kern)}; bound {bnd:.5f} ms "
                  f"({nb} bytes, {ops} adds); plain version {fmt_ms(pl)}"
                  f"{' (profiler sum: bincount is not capturable)' if counts else ''}; library index_add_ "
                  f"{fmt_ms(lib)}{' (sums only)' if counts else ''} ({card})")
    if extras:
        x1 = torch.cat([x, torch.ones(n, 1, device=dev)], 1)
        gemm = both_ms(lambda: F.one_hot(idx64, k).float().T @ x), both_ms(lambda: F.one_hot(idx64, k).float().T @ x1)
        sets = [(torch.randn(n, d, generator=gen, device=dev), accum_indices(kind, n, k, gen)) for _ in range(8)]
        cold = {
            "vq_codebook_grad": graph_ms([lambda s=s: codebook_grad_cuda(s[1], s[0], k) for s in sets]),
            "vq_codebook_stats": graph_ms([lambda s=s: codebook_stats_cuda(s[1], s[0], k) for s in sets]),
            "index_add_": graph_ms([lambda s=s, i=s[1].long(): torch.zeros(k, d, device=dev).index_add_(0, i, s[0])
                                    for s in sets]),
        }
        phase(ph, f"the same over eight input sets in turn (cold L2), on the card: "
                  + ", ".join(f"{name} {t:.5f} ms" for name, t in cold.items())
                  + f"; one-hot GEMM {fmt_ms(gemm[0])}, on [x | 1] {fmt_ms(gemm[1])} ({card})")
    return out


def launch_floor(ph: int, card: str):
    """One launch of a kernel that does nothing: the card's floor for a launch."""
    import ctypes

    import torch
    from acoustic_locating_vq_vae_torch.ops import kernels

    noop = kernels.library("vq_nearest.cu").vq_noop_launch
    noop.argtypes, noop.restype = [ctypes.c_void_p], ctypes.c_int

    def fn():
        if noop(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the empty kernel did not launch")

    floor = both_ms(fn)
    phase(ph, f"launch floor, an empty <<<1, 32>>> kernel: {fmt_ms(floor)} ({card})")
    return floor


def time_serving_kernels(dev, card: str) -> dict:
    """Phase 4's kernel timings: vq_nearest at the serving shapes."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    launch_floor(4, card)
    time_nearest(4, 8 * 201, 64, 1024, gen, card)
    return time_nearest(4, N_SERVE, 64, 1024, gen, card)


def time_training_kernels(dev, card: str):
    """Phase 7's kernel timings: every kernel at the speech and RIR stages'
    training shapes, the accumulation also on skewed indices."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    time_nearest(7, RIR_N, 64, 1024, gen, card)
    near = time_nearest(7, SPEECH_N, SPEECH_D, SPEECH_K, gen, card)
    accum = time_accum(7, SPEECH_N, SPEECH_D, SPEECH_K, "uniform", gen, card, extras=True)
    for kind in ("32 codes", "one code"):
        time_accum(7, SPEECH_N, SPEECH_D, SPEECH_K, kind, gen, card)
    time_accum(7, RIR_N, 64, 1024, "uniform", gen, card)
    return near, accum


def check_nearest(vq, nearest_cuda, dev) -> float:
    """Phase 2: vq_nearest against its plain version under the tie rule at
    the paths' shapes and at the shapes that reach each branch of the kernel
    (split codebook, K below and off a code tile, unaligned D, D above the
    resident x tile), and exactly where the answer is known: duplicated
    codebook rows, +-0.0 scores, NaN rows, all ties; two launches equal.
    Returns the largest float64 score gap on rows that differ."""
    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32

    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    report = []
    with full_fp32():
        for n, d, k in [(N_SERVE, 64, 1024), (8 * 201, 64, 1024), (SPEECH_N, SPEECH_D, SPEECH_K),
                        (RIR_N, 64, 1024), (100, 4, 16), (513, 128, 100), (8 * 201, 64, 100), (8 * 201, 64, 16),
                        (1000, 129, 300), (300, 6, 1024), (2000, 256, 520)]:
            x = torch.randn(n, d, generator=gen, device=dev)
            cb = torch.randn(k, d, generator=gen, device=dev)
            e2 = (cb * cb).sum(1)
            first = nearest_cuda(x, cb, e2)
            if not torch.equal(first, nearest_cuda(x, cb, e2)):
                raise AssertionError(f"kernel ({n}, {d}, {k}): two launches differ")
            want = vq.nearest_indices(x, cb, e2)
            torch.cuda.synchronize()
            mism, gap = check_codes(x, cb, first.long(), want, f"kernel ({n}, {d}, {k})")
            max_err = max(max_err, gap)
            report.append(f"({n},{d},{k}): {mism} tie rows differ")

        def exact(label, x, cb, want):
            got = nearest_cuda(x, cb, (cb * cb).sum(1)).cpu()
            if not torch.equal(got, want.to(torch.int32).cpu()):
                bad = torch.nonzero(got != want.to(torch.int32).cpu()).flatten()
                raise AssertionError(f"{label}: {bad.numel()} rows wrong, first {bad[:5].tolist()} got "
                                     f"{got[bad[:5]].tolist()}")

        # every code twice, the copy in the upper half: the lower index must win,
        # within one slice (N large) and across the cluster's slices (N = 1,608)
        for n in (8 * 201, N_SERVE):
            x = torch.randn(n, 64, generator=gen, device=dev)
            half = torch.randn(512, 64, generator=gen, device=dev)
            cb = torch.cat([half, half])
            want = vq.nearest_indices(x, half, (half * half).sum(1))
            got = nearest_cuda(x, cb, (cb * cb).sum(1)).long()
            if bool((got >= 512).any()):
                raise AssertionError(f"duplicated codebook rows at N={n}: {int((got >= 512).sum())} rows took the copy")
            check_codes(x, half, got, want, f"duplicated codebook rows at N={n}")
        # a zero row scores +0.0 on code 3 (a zero row) and -0.0 on code 700
        # (e2 = -0.0 given by hand); they tie, so the lower index wins
        cb = torch.randn(1024, 64, generator=gen, device=dev) + 3.0
        cb[3] = 0.0
        cb[700] = 0.0
        e2 = (cb * cb).sum(1)
        e2[700] = -0.0
        x = torch.zeros(1608, 64, device=dev)
        got = nearest_cuda(x, cb, e2).cpu()
        if not torch.equal(got, torch.full((1608,), 3, dtype=torch.int32)):
            raise AssertionError(f"+0.0 against -0.0 must go to the lower code 3, got {got.unique().tolist()}")
        x = torch.randn(300, 64, generator=gen, device=dev)
        x[7] = float("nan")
        cb = torch.randn(1024, 64, generator=gen, device=dev)
        got = nearest_cuda(x, cb, (cb * cb).sum(1))
        if int(got[7]) != 0:
            raise AssertionError(f"a row of NaN must take code 0, got {int(got[7])}")
        exact("all ties", torch.ones(8, 4, device=dev), torch.ones(6, 4, device=dev), torch.zeros(8))
        exact("all ties across slices", torch.ones(1608, 64, device=dev), torch.ones(1024, 64, device=dev),
              torch.zeros(1608))
    phase(2, f"kernel == plain, two launches equal, at {'; '.join(report)}; duplicated codebook rows, +-0.0 scores "
             f"and all ties -> the lower index; a NaN row -> code 0; max float64 score gap on differing rows {max_err}")
    return max_err


def check_accum(vq, grad_cuda, stats_cuda, dev) -> float:
    """Phase 5: both kernel modes against the plain versions, and two
    launches bitwise equal. Returns the largest |kernel - plain|."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    report = []
    cases = [(SPEECH_N, SPEECH_D, SPEECH_K, "uniform"), (RIR_N, 64, 1024, "uniform"), (100, 4, 16, "uniform"),
             (513, 129, 100, "uniform"), (SPEECH_N, SPEECH_D, SPEECH_K, "one code"),
             (SPEECH_N, SPEECH_D, SPEECH_K, "32 codes"), (20000, 4, 16, "uniform"), (3000, 129, 1024, "32 codes"),
             (70001, 30, 9, "uniform")]
    for n, d, k, kind in cases:
        x = torch.randn(n, d, generator=gen, device=dev)
        idx = accum_indices(kind, n, k, gen)
        grad = grad_cuda(idx, x, k)
        counts, sums = stats_cuda(idx, x, k)
        want_counts, want_sums = vq.codebook_stats_plain(idx, x.double(), k)
        want_grad = want_sums
        same = torch.equal(grad, grad_cuda(idx, x, k))
        again = stats_cuda(idx, x, k)
        same = same and torch.equal(counts, again[0]) and torch.equal(sums, again[1])
        torch.cuda.synchronize()
        label = f"({n}, {d}, {k}, {kind})"
        for name, got, want in (("grad", grad, want_grad), ("sums", sums, want_sums)):
            err = float((got - want).abs().max())
            limit = ACCUM_RTOL * max(1.0, float(want.abs().max()))
            if err > limit:
                raise AssertionError(f"vq_codebook_accum {name} at {label}: max |kernel - plain| {err} > {limit}")
            worst = max(worst, err)
        if not torch.equal(counts, want_counts):
            raise AssertionError(f"vq_codebook_stats counts at {label} differ from bincount")
        if not same:
            raise AssertionError(f"vq_codebook_accum at {label}: two launches differ")
        report.append(f"{label} max err {float((grad - want_grad).abs().max()):.3g}")
    idx = torch.randint(-3, 20, (5000,), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn(5000, 8, generator=gen, device=dev)
    keep = (idx >= 0) & (idx < 16)
    want = vq.codebook_grad_plain(idx[keep], x[keep].double(), 16)
    err = float((grad_cuda(idx, x, 16) - want).abs().max())
    if err > ACCUM_RTOL * max(1.0, float(want.abs().max())):
        raise AssertionError(f"indices outside [0, K) were not skipped: err {err}")
    phase(5, f"vq_codebook_grad and vq_codebook_stats == plain (rule {ACCUM_RTOL} x max(1, max|plain|); "
             f"counts exact) and deterministic at {'; '.join(report)}; indices outside [0, K) skipped")
    return worst


def latent_codebook_(model, x, g) -> None:
    """Replace the codebook by K pre-VQ latent rows of ``x`` (an untrained
    U(+-1/K) codebook makes the argmin a near-tie lottery)."""
    import torch

    with torch.no_grad():
        z = model.pre_vq_latent(x)
        rows = (z if model.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, model.embedding_dim)
        cb = rows[torch.randperm(rows.shape[0], generator=g)[: model.num_embeddings]]
        model._vq._embedding.weight.copy_(cb)
        if model._vq.ema:
            model._vq.ema_sums.copy_(cb)


def make_batch(b: int, g, device):
    """A seeded batch of power spectrograms and targets at the dataset's
    geometry (201 bins x 500 frames)."""
    import torch
    from acoustic_locating_vq_vae_torch.data import SampleBatch

    spec = lambda: torch.empty(b, 201, 500, device=device).exponential_(generator=g)
    return SampleBatch(
        spec(), spec(), spec(), torch.full((b,), 16000, device=device), torch.zeros(b, device=device),
        torch.empty(b, 201, device=device).exponential_(generator=g), torch.ones(b, device=device),
    )


@contextlib.contextmanager
def card_precision(tf32: bool, deterministic: bool):
    """Allow TF32 (cuDNN and cuBLAS) or not, and pin cuDNN to its deterministic
    algorithms or not; the old settings come back on exit. ``Trainer.step``
    runs at (False, True); the other settings are this script's controls and
    yardsticks, not switches of the program."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    cudnn.deterministic = deterministic
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


# (tf32, deterministic) of the control steps beside the program's own step
CONTROLS = {"repeat": (False, True), "default algorithms": (False, False),
            "default algorithms, repeat": (False, False), "TF32": (True, True)}


def control_grads(tr, task, batch, tf32: bool, deterministic: bool):
    """Gradients of the trainer's next step (loss and backward, no update)
    on a copy of its model, from its jitter state, under the given settings."""
    import torch

    model = copy.deepcopy(tr.model)
    jitter = torch.Generator()
    jitter.set_state(tr.jitter_generator.get_state())
    with card_precision(tf32, deterministic):
        task.loss(model, batch, True, jitter)[0].backward()
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def train_step_card_vs_cpu(task, dev, counters, label: str, seed: int):
    """Phase 6: one train step of ``task`` on the card and on the CPU from the
    same seed, batch and jitter decisions, and the same step's gradients on
    the CPU in float64 as the reference. Before the card's step, the control
    steps of CONTROLS run on copies of its model. Checks codes, loss, metrics,
    EMA buffers and that the repeat equals the step bitwise; returns the card
    run's launches, per step and control (the worst gradient distance from
    float64 over that gradient's largest entry, its name), which the caller
    checks, and whether two steps with cuDNN's default algorithms were
    bitwise equal."""
    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.train import Trainer

    g = torch.Generator().manual_seed(seed)
    data = make_batch(2 * CHECK_B, g, "cpu")
    seed_batch = make_batch(8, g, "cpu")  # >= K = 1024 latent rows in both stages
    trainers = {"cpu": Trainer(task, device="cpu", seed=seed + 1, verbose=False),
                "card": Trainer(task, device=dev, seed=seed + 1, verbose=False)}
    cpu_model = trainers["cpu"].model
    with full_fp32():
        latent_codebook_(cpu_model, task.model_inputs(seed_batch)[0], g)
    trainers["card"].model.load_state_dict(cpu_model.state_dict())
    ref_model = copy.deepcopy(cpu_model).double()
    jitter_state = trainers["cpu"].jitter_generator.get_state()
    runs = {}
    for name, tr in trainers.items():
        batch = tr.sample(tr.to_device(data))
        if name == "cpu":
            cpu_batch = batch
        codebook = tr.model._vq._embedding.weight.detach().cpu().clone()
        with torch.no_grad(), full_fp32():
            x = task.model_inputs(batch)[0]
            codes = tr.model.get_latent_codes(x).flatten().cpu()
            z = tr.model.pre_vq_latent(x)
            rows = (z if tr.model.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, tr.model.embedding_dim).cpu()
        if name == "card":
            controls = {c: control_grads(tr, task, batch, *setting) for c, setting in CONTROLS.items()}
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
        metrics = tr.step(batch)
        if name == "card":
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
        grads = {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}
        buffers = {k: b.detach().cpu() for k, b in tr.model.named_buffers()}
        runs[name] = (codes, rows, codebook, {k: float(v) for k, v in metrics.items()}, grads, buffers)
    (c_cpu, rows_cpu, cb_cpu, m_cpu, g_cpu, b_cpu) = runs["cpu"]
    (c_card, _, _, m_card, g_card, b_card) = runs["card"]
    mism, gap = check_codes(rows_cpu, cb_cpu, c_card, c_cpu, f"{label} codes card vs CPU")

    # the reference: the same step in float64 on the CPU
    batch64 = cpu_batch.map(lambda a: a.double() if a.is_floating_point() else a)
    with torch.no_grad():  # before the step moves an EMA codebook
        codes64 = ref_model.get_latent_codes(task.model_inputs(batch64)[0]).flatten()
    jitter = torch.Generator()
    jitter.set_state(jitter_state)
    loss64, _ = task.loss(ref_model, batch64, True, jitter)
    loss64.backward()
    check_codes(rows_cpu, cb_cpu, codes64, c_cpu, f"{label} codes float64 vs float32 CPU")
    g64 = {k: p.grad.detach() for k, p in ref_model.named_parameters()}

    for k, v in m_cpu.items():
        if not math.isfinite(m_card[k]) or abs(m_card[k] - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f"{label}: {k} card {m_card[k]} vs CPU {v}, rtol {LOSS_RTOL}")
    for k, v in b_cpu.items():
        err = float((b_card[k] - v).abs().max())
        if err > LOSS_RTOL * max(1.0, float(v.abs().max())):
            raise AssertionError(f"{label}: EMA buffer {k} differs by {err}")
    for k, v in controls["repeat"].items():
        if not torch.equal(v, g_card[k]):
            raise AssertionError(f"{label}: the gradient of {k} differs between two identical card steps")
    default_same = all(torch.equal(v, controls["default algorithms, repeat"][k])
                       for k, v in controls["default algorithms"].items())
    steps = {"card": g_card, "float32 CPU": g_cpu, "default algorithms": controls["default algorithms"],
             "TF32": controls["TF32"]}
    worst = {}
    for step, grads in steps.items():
        worst[step] = max((float((grads[k].double() - ref).abs().max() / ref.abs().max()), k) for k, ref in g64.items())
    phase(6, f"{label} train step at full width, B={CHECK_B}, seed {seed}: launches {launches}; codes differ on "
             f"{mism} tie rows (gap {gap}); loss card {m_card['loss']} vs CPU {m_cpu['loss']} vs float64 "
             f"{loss64.item()}; metrics within rtol {LOSS_RTOL}; {len(b_cpu)} EMA buffers agree; gradients "
             f"bitwise equal over two card steps (with cuDNN's default algorithms "
             f"{'equal' if default_same else 'not equal'}); worst distance from float64 over each of {len(g64)} "
             f"gradients' max: " + ", ".join(f"{step} {v:.3g} ({k})" for step, (v, k) in worst.items()))
    return launches, worst, default_same


def step_times_ms(trainer, data, steps: int = 10, warmup: int = 3):
    """Median host-clock time of one train step (sample + loss + backward +
    Adam), synchronised before and after, after warm-up."""
    import torch

    for _ in range(warmup):
        trainer.step(trainer.sample(data))
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(trainer.sample(data))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def yardstick_step_ms(trainer, data, tf32: bool, deterministic: bool, steps: int = 10, warmup: int = 3) -> float:
    """Median host-clock time of the trainer's step (sample + loss + backward
    + Adam) under other settings than the program's (see card_precision)."""
    import torch

    model, opt, task = trainer.model, trainer.optimizer, trainer.task
    times = []
    for i in range(warmup + steps):
        batch = trainer.sample(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with card_precision(tf32, deterministic):
            opt.zero_grad(set_to_none=True)
            loss, _ = task.loss(model, batch, True, trainer.jitter_generator)
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
    from acoustic_locating_vq_vae_torch.ops.vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda
    from acoustic_locating_vq_vae_torch.train import (
        JointLocationTask, LocationTask, RirVQVAETask, SpeechVQVAETask, Trainer,
    )

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: {line.strip()}", flush=True)

    if KERNELS_ONLY in sys.argv[1:]:
        check_nearest(vq, nearest_indices_cuda, dev)
        check_accum(vq, codebook_grad_cuda, codebook_stats_cuda, dev)
        time_serving_kernels(dev, card)
        time_training_kernels(dev, card)
        return 0

    # ---- phase 2: kernel vs plain on the card
    max_err = check_nearest(vq, nearest_indices_cuda, dev)

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

    near_serve = time_serving_kernels(dev, card)
    del outs
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()  # the capture stream's, or it counts in phase 7's peak memory
    torch.cuda.empty_cache()

    # ---- phase 5: the codebook-accumulation kernel vs plain on the card
    accum_err = check_accum(vq, codebook_grad_cuda, codebook_stats_cuda, dev)

    # ---- phase 6: the training slice at full width, card vs CPU
    counters = (nearest_indices_cuda, codebook_grad_cuda, codebook_stats_cuda)
    train_launches = {}
    grad_worst = {}
    default_differs = 0
    for label, task, seeds in (("speech", SpeechVQVAETask(), GRAD_SEEDS), ("rir", RirVQVAETask(), GRAD_SEEDS),
                               ("speech EMA", SpeechVQVAETask(vq_ema=True), GRAD_SEEDS[:1])):
        for seed in seeds:
            got, worst, default_same = train_step_card_vs_cpu(task, dev, counters, label, seed)
            default_differs += not default_same
            needed = ("nearest_indices_cuda", "codebook_stats_cuda" if task.vq_ema else "codebook_grad_cuda")
            for name in needed:
                if got[name] < 1:
                    raise AssertionError(f"{label} train step never launched {name}")
            train_launches.setdefault(label, got)
            for step, w in worst.items():
                grad_worst.setdefault(label, {}).setdefault(step, []).append(w[0])
            torch.cuda.empty_cache()
    phase(6, f"worst gradient distance from float64 over each gradient's max, per stage and step over its "
             f"seeds (limit {GRAD_RTOL} for the card's step): " + "; ".join(
                 f"{label}: " + ", ".join(f"{step} {max(ws):.3g}" for step, ws in steps.items())
                 for label, steps in grad_worst.items())
             + f"; two steps with cuDNN's default algorithms differed in {default_differs} of "
             f"{2 * len(GRAD_SEEDS) + 1} cases")
    for label, steps in grad_worst.items():
        if max(steps["card"]) > GRAD_RTOL:
            raise AssertionError(f"{label}: a card gradient is {max(steps['card'])} of its max from float64, "
                                 f"limit {GRAD_RTOL}")

    # ---- phase 7: timings on the card
    g7 = torch.Generator(device=dev).manual_seed(7)
    data = make_batch(2 * TRAIN_B, g7, dev)
    step_ms = {}
    for label, task in (("speech", SpeechVQVAETask()), ("rir", RirVQVAETask())):
        trainer = Trainer(task, device=dev, seed=8, verbose=False)
        torch.cuda.reset_peak_memory_stats()
        med, times = step_times_ms(trainer, data)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_ms[label] = med
        phase(7, f"{label} train step at B={TRAIN_B}, full width, TF32 off: median {med:.4f} ms over "
                 f"{len(times)} steps (min {min(times):.4f}, max {max(times):.4f}), "
                 f"{TRAIN_B * 500 / med * 1e3:.1f} frames/s, peak memory {peak_gb:.3f} GB ({card})")
        if label == "speech":
            wall_us, busy_us, top = device_breakdown(
                lambda b: trainer.step(trainer.sample(b)), [data] * 3, top=8)
            if busy_us == 0:
                phase(7, "speech step: the profiler recorded no device time")
            else:
                tops = "; ".join(f"{kname[:70]} x{c} {t / 3 / 1e3:.3f} ms ({t / busy_us:.1%})" for kname, c, t in top)
                phase(7, f"speech step profiled, per step: {wall_us / 3 / 1e3:.4f} ms host clock, card busy "
                         f"{busy_us / 3 / 1e3:.4f} ms ({busy_us / wall_us:.1%}); kernels by device time: {tops}")
            tf32 = yardstick_step_ms(trainer, data, tf32=True, deterministic=True)
            phase(7, f"speech train step at B={TRAIN_B} with TF32 allowed (yardstick only): median {tf32:.4f} ms, "
                     f"{TRAIN_B * 500 / tf32 * 1e3:.1f} frames/s, {med / tf32:.2f}x the FP32 step ({card})")
        free = yardstick_step_ms(trainer, data, tf32=False, deterministic=False)
        phase(7, f"{label} train step at B={TRAIN_B}, TF32 off, cuDNN's default algorithms (yardstick of the "
                 f"deterministic pin): median {free:.4f} ms, the program's step {med / free:.3f}x as long ({card})")
        del trainer
        torch.cuda.empty_cache()

    _, accum = time_training_kernels(dev, card)
    phase(7, f"launches per train step: speech {train_launches['speech']}, speech EMA {train_launches['speech EMA']}, "
             f"rir {train_launches['rir']}")

    def accum_entry(name, source_line, label, counter):
        return {"name": name, "route": "cuda",
                "source": "src/acoustic_locating_vq_vae_torch/csrc/vq_codebook_accum.cu",
                "replaces": f"src/acoustic_locating_vq_vae_tpu/ops/vq_pallas.py:{source_line}",
                "launches": train_launches[label][counter], "max_abs_err": accum_err, **accum[name]}

    print(json.dumps({"kernels": [{
        "name": "vq_nearest",
        "route": "cuda",
        "source": "src/acoustic_locating_vq_vae_torch/csrc/vq_nearest.cu",
        "replaces": "src/acoustic_locating_vq_vae_tpu/ops/vq_pallas.py:49",
        "launches": sum(launches.values()) + sum(t["nearest_indices_cuda"] for t in train_launches.values()),
        "max_abs_err": max_err,
        **near_serve,
    }, accum_entry("vq_codebook_grad", 68, "speech", "codebook_grad_cuda"),
        accum_entry("vq_codebook_stats", 150, "speech EMA", "codebook_stats_cuda"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
