#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it against itself.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1, 2 and 5 and the kernels' timings only
    python3 chip_smoke.py --converge  # phase 1, then the speech and RIR stages to a known loss, FP32 and bf16
    python3 chip_smoke.py --bf16      # phases 1, 2, 3, 8 and 13 only
    python3 chip_smoke.py --otf       # phases 1 and 12 only (--full-bank: run K's whole 1024-angle bank)
    python3 chip_smoke.py --deploy    # phases 1 and 14 only

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
   VQ-VAE (three seeds) at B = 8 on the card and on the CPU from the same
   seeded weights, batch and jitter decisions; codes, loss, metrics and the EMA
   buffers agree, every card gradient lies within GRAD_RTOL of the same step in
   float64, and a repeat of the card's step is bitwise equal; the gradients of
   control steps (cuDNN's default algorithms, TF32) are printed beside it;
   launch counts show the steps went through the kernels;
7. timings on the card: median train step and frames/s at B = 32 for both
   stages and the speech stage's EMA mode, a profiler breakdown of the speech
   step, yardstick steps with TF32 allowed (speech) and with cuDNN's default
   algorithms (each stage), and each kernel at the speech and RIR shapes (the
   accumulation also with 32 codes and one code in use, and with a cold L2)
   beside its bound, its plain version and library yardsticks;
8. the composite and location stages at full width: one train step each of
   the echoed stage (uncached and from the frozen-latent cache), the finetune
   stage, the frozen location stage (uncached and cached) and the joint stage
   (sincos + radius, tail term) at B = 4 on the card and on the CPU from the
   same seeded weights (codebooks of latent rows), batch and jitter decisions:
   codes under the tie rule, loss and metrics within LOSS_RTOL, every trained
   gradient within GRAD_RTOL (the location stage's within LOCATION_GRAD_RTOL,
   the echoed stage's within ECHOED_GRAD_RTOL, at the three GRAD_SEEDS)
   of the same step in float64 on the CPU, a TF32 control step's gradients
   printed beside it and failing the stage's limit, the cached loss within CACHE_RTOL of the uncached one on
   the card, the echoed branches bitwise unchanged over three steps, and the
   kernels' launches per step (vq_nearest once per frozen branch run, the
   accumulation never);
9. timings on the card: each of those stages' train step at its own batch
   size (echoed and finetune B = 64, frames/s = 64 x 500 / step time; location
   and joint B = 16), the cache build per sample, peak memory, a profiler
   breakdown of each step, vq_nearest at the two shapes these stages add
   (N = 32,000, D = 128 and N = 3,216, D = 64), and one save_checkpoint and one
   restore_latest of the compat location trainer (fc_1 and Adam's moments,
   about 2.5 GB) with their share of that stage at the default ckpt_every;
10. the pipeline at full width (``pipeline_phase``) on training and
   validation sets synthesized on the card from the seed, as the CLI does
   without --data-dir: run_pipeline in this process on the CLI's own
   ``load_datasets`` (run A), then the pipeline CLI in a subprocess with the
   same flags, stopped by a real SIGTERM in the echoed stage (run B, exit 75),
   then rerun with --resume (run C): six stage finals with their metadata, the
   kernels' launches in every stage, finite evaluations on the synthesized
   validation rows, the completed stages skipped, and run C's finals bitwise
   equal to run A's (so three processes synthesized the same sets); per stage
   the wall time, step time, cache build, checkpoint bytes, save and restore
   ms and the share of the wall time outside Trainer.step; a profiler trace
   of one stage;
11. synthesis at the full geometry (``synthesis_phase``; 201 x 500 frames,
   6400-tap RIRs over the 179,443 images of the geometry-boxed lattice): at
   three seeds a B = 64 batch on the card against the port in float64 on the
   CPU from the same draws (its first SYNTH_CHECK_B rows; RIRs, the three
   spectrograms and the Wiener estimate under SYNTH_LIMITS), the speech's
   float32 phase drift card vs CPU, two synthesize_batch and two
   generate_rir_batch runs bitwise equal, every option once (rt60_range,
   radius_range, snr_range with snr_clean_prob and the SNR read back from the
   spectrograms, fixed_rir, fixed_speech, a given geometry replayed bitwise),
   and the timings: synthesize_batch in samples/s and generate_rir_batch in
   RIRs/s at B = 64 (medians of 10, peak memory, the RIR by chunk size), a
   profiler breakdown of one batch, and make_dataset of the CLI's default
   1000 + 200 rows;
12. on-the-fly training with run K's options (``otf_phase``; full width and
   geometry): run K's RIR bank (OTF_BANK_THETA angles, or 1024 with
   --full-bank, x 8 T60s x 8 radii) built and timed, three cells bitwise
   equal to generate_rir_batch on the card and rows within SYNTH_LIMITS of
   float64; a pure-bank and a mixed batch whose bank samples carry their
   gathered cell's angle and radius and match exact synthesis at those
   labels; every stage's train step resident and on the fly (the joint stage
   also from the bank and mixed), the synthesis's share of the step; and the
   recipe through the CLI (--on-the-fly --joint-location --predict-radius
   --bank-pretrain-updates, run K's ranges, a small bank): the hard switch
   and --polish-bank-prob 0.25 in this process with their launches, then a
   real SIGTERM in the bank leg and one in the polish leg, each followed by
   --resume, ending bitwise equal to the uninterrupted run.

13. bf16 ``compute_dtype`` (``bf16_phase``): (a) one bf16 train step of every
   stage (speech and RIR with the gradient and the EMA codebook, echoed
   uncached and cached, finetune, location, joint) at B = 4 on the card from
   the FP32 steps' weights, against the CPU port's bf16 step and the same step
   in float64, both fed the card's latents: the launches, a finite float32 loss,
   float32 parameters and Adam state, the card's codes on its own latent
   against the CPU plain assignment (tie rule), every gradient within
   BF16_FRACTION of the CPU bf16 step's distance from float64, the codes'
   agreement with the FP32 step; (b) every stage's step at its own batch size,
   FP32 and bf16, with and without the deterministic pin, the bf16 step's
   launches, loss, parameters and codes at that size, the TF32 speech
   yardstick, profiles of the speech and echoed bf16 steps by kernel class;
   (c) the joint and frozen localizers served from bf16 tasks at B = 8 and 64
   beside FP32 serving (latency, largest |delta theta|); (d) phase 10's
   pipeline with --compute-dtype bfloat16, preempted and resumed bitwise.

14. the deploy surface (``deploy_phase``) at full width, on a store of seeded
   weights written as the pipeline writes one (phase 10 deletes its own): (a)
   the export CLI writes the joint (symbolic batch), the frozen (the 843 MB
   fc_1) and the joint --from-audio artifacts, each verified against the live
   model, with its bytes and export seconds; (b) a fresh process that imports
   torch and ops.vq alone (the VQ operator's registration) loads each cold and
   runs B = 1, 8 and 64: within ATOL of the live closure, the operator once in
   each graph and no argmin, one vq_nearest launch per call; (c) the card's
   artifact against the CPU port at B = 8 under the tie rule; (d) a control run
   under cuDNN's default TF32 (not gated); (e) the --from-audio artifact on
   80,000-sample waveforms; (f) a bf16 joint artifact against its live
   closure; (g) serve latency of artifact and live closure in turns at B = 8
   and 64; (h) locate, track, eval_t60_sweep, compare_location_models and
   resynthesize on the card: exit 0, the JAX scripts' JSON keys.

Phase 2 also holds the registered operator (``torch.ops.acoustic_locating_vq_vae_torch.vq_nearest``,
through which the main path reaches the kernel) equal to the wrapper, and
phase 4 reads its dispatch cost beside the B = 8 serve latency.

``--converge`` trains the speech and RIR VQ-VAEs at full width for 1,500
updates each on 256 + 64 synthesized rows, in FP32 and in bf16 from the same
seed, and prints the recon of the first and last 100 updates, the perplexity
and the validation recon (the JAX package's VALIDATION.md figures beside them,
not gated); it fails where bf16's recon of the last 100 updates exceeds
CONVERGE_BF16_LIMIT times FP32's.

A kernel's time is read twice: on the card (some tens of calls captured in one
CUDA graph and replayed between two events, so no host work lies between the
launches) and as the enqueue time (two events around back-to-back Python
calls, which for a call of tens of microseconds is the host's launch rate).
The ``kernels`` line carries the card's time, one entry for each kernel and
shape that was both timed and run by the main path's checked and timed runs
(phases 3, 6 to 10, 12, 13 and 14's served artifacts), with the launches
counted at that shape (``count_by_shape``).

Then a JSON line of per-kernel numbers and, last, ``{"ok": true, "device":
...}``. Any failure raises, and the exit code is not 0.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import re
import shutil
import signal
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
ECHOED_N = 64 * 500  # the echoed and finetune stages' speech-branch VQ rows at B = 64, D = 128
LOCATION_N = 16 * 201  # the location and joint stages' RIR-branch VQ rows at B = 16, D = 64
GRAD_SEEDS = (6, 60, 600)  # phase 6's gradient-mode steps; the EMA step uses the first
LOSS_RTOL = 1e-4
# Every gradient of the card's step must lie within GRAD_RTOL of its largest
# entry from the same step in float64 on the CPU. Set from phase 6's readings
# on the H100 (PERF.md): full-FP32 steps, on the card or on the CPU, read up
# to 5.9e-3 (the speech stage's gradients are ill-conditioned), TF32 steps
# 5.0e-2 to 0.17; 1e-2 passes the first and fails the second.
GRAD_RTOL = 1e-2
# The location stage trains the head alone, whose gradients pass through no
# ill-conditioned convolution: full-FP32 steps, on the card or on the CPU,
# read 2.3e-7 to 3.5e-7 of their max from float64, its TF32 control step
# 5.6e-4 (PERF.md), so the stage has a limit of its own between the two.
LOCATION_GRAD_RTOL = 1e-5
# The echoed stage (cached or not) trains the composite decoder alone behind the frozen branches: full-FP32
# steps read 2.9e-4 to 4.2e-4 of their max from float64 at seed 80, its TF32 control steps 1.95e-3 (cached)
# and 1.45e-2 (PERF.md), so GRAD_RTOL let a TF32 leak through the cached step. A limit of its own, between
# the two, checked at the three GRAD_SEEDS. The finetune stage stays on GRAD_RTOL: its FP32 step reads 1.84e-3
# (the encoders' first layers, as the speech stage's), above the echoed cached stage's TF32 control, and its
# own TF32 control reads 0.119.
ECHOED_GRAD_RTOL = 1e-3
# of max(1, max |plain|), the plain version run in float64: the kernel sums
# FP32 rows in its own fixed order
ACCUM_RTOL = 1e-5
# phase 10: the pipeline at full width, a few updates a stage, in a scratch directory of the checkout
PIPE_ROOT = REPO / "build" / "chip_smoke"
PIPE_UPDATES, PIPE_CKPT_EVERY, PIPE_SEED = 8, 2, 5
PIPE_WIDTH = 1.0  # width_scale of phase 10's stages: full width
PIPE_ROWS = {"train": 64, "val": 16}
# phase 11: synthesis at the full geometry
SYNTH_B = 64
SYNTH_SEEDS = (11, 12, 13)
SYNTH_CHECK_B = 8  # rows of each card batch also synthesized in float64 on the CPU from the same draws
SYNTH_CHUNK = 8192  # lattice images per step of the RIR's walk (synthesize_batch's rir_chunk)
SYNTH_CHUNK_SWEEP = (2048, 4096, 8192, 16384)
SYNTH_IMAGES = 179443  # the geometry-boxed lattice at radius 1 m
# card vs the port in float64 on the CPU, max |error| / max |float64| (rir_spec after each sample's scale).
# Set from the H100's readings at SYNTH_SEEDS (PERF.md): rir 2.9e-5, speech_spec 2.6e-7, echoed_spec
# 1.2e-5, wiener_est 8.2e-5, rir_spec 1.5e-3; each limit about 3x its reading
SYNTH_LIMITS = {"rir": 1e-4, "speech_spec": 1e-6, "echoed_spec": 5e-5, "wiener_est": 3e-4, "rir_spec": 5e-3}
SNR_TOL_DB = 0.15  # measured on the waveform; the 80,000 noise samples' own power spreads 0.02 dB (1 sigma)
SYNTH_DATASET_ROWS = (1000, 200)  # the CLI's default training and validation sets
# `python3 chip_smoke.py --converge`: the build, then the speech and RIR stages to a known loss only
CONVERGE = "--converge"
CONVERGE_UPDATES, CONVERGE_SEED = 1500, 21
CONVERGE_ROWS = {"train": 256, "val": 64}
# phase 12: on-the-fly training with run K's options (scripts/run_runK.sh) at full width and geometry
OTF = "--otf"  # `python3 chip_smoke.py --otf`: phase 1 and phase 12 only
FULL_BANK = "--full-bank"  # phase 12 builds run K's whole 1024-angle bank (about 140 s) instead of OTF_BANK_THETA
OTF_BANK_THETA = 128  # run K's 1024 angles cut to fit the script's time; its 8 T60s x 8 radii stay
OTF_RANGES = {"rt60_range": (0.12, 0.75), "radius_range": (0.45, 1.45)}
OTF_NOISE = {"snr_range": (0.0, 30.0), "snr_clean_prob": 0.25}
OTF_GRID = 8  # T60s and radii of run K's bank, np.linspace over the ranges
OTF_SEED, OTF_LABEL_B = 12, 16
OTF_WIDTH = 1.0  # width_scale of phase 12's stages
OTF_CONFIG = None  # None: the dataset's full geometry (201 x 500, 6400-tap RIRs)
OTF_CLI_EXTRA = ()  # flags added to every CLI run of phase 12
# the recipe through the CLI: RECIPE_UPDATES a stage, the joint stage's first RECIPE_BANK from a small bank
RECIPE_UPDATES, RECIPE_BANK, RECIPE_BANK_SIZE = 16, 8, (16, 2, 2)
# `python3 chip_smoke.py --bf16`: phases 1 to 3 (the kernel checks and the localizers' weights), 8 and 13
BF16_ONLY = "--bf16"
# `python3 chip_smoke.py --kernels` runs only what needs no model: the build,
# the kernels against their plain versions (phases 2 and 5) and their timings
# (of phases 4 and 7); a short run for working on a kernel
KERNELS_ONLY = "--kernels"
# `python3 chip_smoke.py --deploy`: phases 1 and 14 only
DEPLOY = "--deploy"
DEPLOY_ROOT = PIPE_ROOT / "deploy"
DEPLOY_WIDTH = 1.0  # width_scale of phase 14's models and CLI runs: full width
DEPLOY_SEED = 140
DEPLOY_BATCHES = (1, 8, SERVE_B)
PKG = "acoustic_locating_vq_vae_torch"
OP_TARGET = f"{PKG}.vq_nearest.default"  # the registered VQ operator as an exported graph names it
# the JSON keys each deploy CLI prints, the JAX package's scripts' own (tests/test_torch_deploy_cli.py checks
# them against those scripts); the port's latency bench adds the device's name
DEPLOY_CLI_KEYS = {
    "locate": {"model", "samples", "rmse_radians", "rmse_radius_m", "latency"},
    "track": {"model", "trajectory", "windows", "window_seconds", "rmse_radians", "median_abs_radians",
              "max_abs_radians", "rmse_smoothed_radians", "rmse_radius_m", "track", "saved"},
    "eval_t60_sweep": {"model", "t60_grid", "radius_grid", "snr_grid_db", "rmse_radians_min", "rmse_radians_max"},
    "compare_location_models": {"finetune", "location_joint"},
}


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


# (kernel, N, D, K) -> launches at that shape in the main path's runs opened with count_by_shape
SHAPE_LAUNCHES = collections.Counter()
# (kernel, N, D, K) -> the kernel's timing at that shape (time_nearest, time_accum on uniform indices)
SHAPE_TIMINGS = {}


@contextlib.contextmanager
def count_by_shape():
    """While open, every launch that the port makes through ``ops.vq`` (the main path's only way to the
    kernels) is also counted in SHAPE_LAUNCHES under its kernel and shape: each wrapper is called through
    a recorder that adds the change of the wrapper's own count. This script's direct calls of the
    wrappers (the kernels against their plain versions, the kernel timings) do not pass through ``ops.vq``
    and are not counted."""
    from acoustic_locating_vq_vae_torch.ops import vq

    shapes = {
        "nearest_indices_cuda": ("vq_nearest", lambda x, cb, e2: (x.shape[0], x.shape[1], cb.shape[0])),
        "codebook_grad_cuda": ("vq_codebook_grad", lambda idx, g, k: (g.shape[0], g.shape[1], k)),
        "codebook_stats_cuda": ("vq_codebook_stats", lambda idx, x, k: (x.shape[0], x.shape[1], k)),
    }

    def recorder(wrapper, kernel, shape):
        def call(*args):
            before = wrapper.launches
            out = wrapper(*args)
            SHAPE_LAUNCHES[(kernel, *shape(*args))] += wrapper.launches - before
            return out
        return call

    saved = {name: getattr(vq, name) for name in shapes}
    for name, (kernel, shape) in shapes.items():
        setattr(vq, name, recorder(saved[name], kernel, shape))
    try:
        yield
    finally:
        for name, wrapper in saved.items():
            setattr(vq, name, wrapper)


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
    # a user annotation (Optimizer.step#Adam.step) carries the device time of the kernels under it: leave
    # it out, as torch's own tables do, or those kernels count twice
    on_card = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
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
    SHAPE_TIMINGS[("vq_nearest", n, d, k)] = dict(ms=kern[0], plain_ms=plain[0], bound_ms=bound, bound_by=by,
                                                   library_ms=lib[0])


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
    lib = both_ms(lambda: torch.zeros(k, d, device=dev).index_add_(0, idx64, x))
    for name, fn, plain, counts in (
        ("vq_codebook_grad", lambda: codebook_grad_cuda(idx, x, k), lambda: vq.codebook_grad_plain(idx, x, k), False),
        ("vq_codebook_stats", lambda: codebook_stats_cuda(idx, x, k), lambda: vq.codebook_stats_plain(idx, x, k), True),
    ):
        kern = both_ms(fn)
        # bincount reads its maximum back to the host, which a graph cannot capture
        pl = both_ms(plain, capturable=not counts)
        bnd, by, ops, nb = accum_bound(n, d, k, counts)
        if kind == "uniform":
            SHAPE_TIMINGS[(name, n, d, k)] = dict(ms=kern[0], plain_ms=pl[0], library_ms=lib[0], bound_ms=bnd,
                                                  bound_by=by)
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


def time_serving_kernels(dev, card: str) -> None:
    """Phase 4's kernel timings: vq_nearest at the serving shapes."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    launch_floor(4, card)
    time_nearest(4, 8 * 201, 64, 1024, gen, card)
    time_nearest(4, N_SERVE, 64, 1024, gen, card)


def op_dispatch(dev, card: str, serve_ms: float) -> None:
    """Phase 4: what the registered operator adds to vq_nearest at the B = 8 serving shape: the enqueue time
    of ``vq.vq_nearest`` (the operator, which computes the row norms and calls the wrapper) against the
    wrapper called with the same row-norm sum, in turns (wrapper, operator, operator, wrapper), and the
    difference as a share of the joint localizer's B = 8 serve latency."""
    import torch
    from acoustic_locating_vq_vae_torch.ops import vq
    from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda

    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(8 * 201, 64, generator=gen, device=dev)
    cb = torch.randn(1024, 64, generator=gen, device=dev)
    wrapper = lambda: nearest_indices_cuda(x, cb, torch.sum(cb * cb, dim=1))
    op = lambda: vq.vq_nearest(x, cb)
    w1, o1, o2, w2 = (event_ms(f) for f in (wrapper, op, op, wrapper))
    cost = (o1 + o2 - w1 - w2) / 2
    phase(4, f"the registered operator at N=1,608: enqueue {o1:.5f} / {o2:.5f} ms, the wrapper {w1:.5f} / "
             f"{w2:.5f} ms with the same row-norm sum; dispatch cost {cost * 1e3:.2f} us, "
             f"{cost / serve_ms:.2%} of the joint B=8 serve latency {serve_ms:.4f} ms"
             + (" (above 5 %)" if cost > 0.05 * serve_ms else "") + f" ({card})")


def time_stage_kernels(dev, card: str) -> None:
    """Phase 9's kernel timings: vq_nearest at the shapes the composite and
    location stages add."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(9)
    time_nearest(9, ECHOED_N, SPEECH_D, SPEECH_K, gen, card)
    time_nearest(9, LOCATION_N, 64, 1024, gen, card)


def time_training_kernels(dev, card: str) -> None:
    """Phase 7's kernel timings: every kernel at the speech and RIR stages'
    training shapes, the accumulation also on skewed indices."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    time_nearest(7, RIR_N, 64, 1024, gen, card)
    time_nearest(7, SPEECH_N, SPEECH_D, SPEECH_K, gen, card)
    time_accum(7, SPEECH_N, SPEECH_D, SPEECH_K, "uniform", gen, card, extras=True)
    for kind in ("32 codes", "one code"):
        time_accum(7, SPEECH_N, SPEECH_D, SPEECH_K, kind, gen, card)
    time_accum(7, RIR_N, 64, 1024, "uniform", gen, card)


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
                        (RIR_N, 64, 1024), (ECHOED_N, SPEECH_D, SPEECH_K), (LOCATION_N, 64, 1024), (100, 4, 16), (513, 128, 100), (8 * 201, 64, 100), (8 * 201, 64, 16),
                        (1000, 129, 300), (300, 6, 1024), (2000, 256, 520)]:
            x = torch.randn(n, d, generator=gen, device=dev)
            cb = torch.randn(k, d, generator=gen, device=dev)
            e2 = (cb * cb).sum(1)
            first = nearest_cuda(x, cb, e2)
            if not torch.equal(first, nearest_cuda(x, cb, e2)):
                raise AssertionError(f"kernel ({n}, {d}, {k}): two launches differ")
            if not torch.equal(vq.vq_nearest(x, cb), first):
                raise AssertionError(f"({n}, {d}, {k}): the registered operator differs from the kernel's wrapper")
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
    phase(2, f"kernel == plain, two launches equal, the registered operator torch.ops.{vq.VQ_NEAREST_OP.replace('::', '.')} "
             f"== the wrapper, at {'; '.join(report)}; duplicated codebook rows, +-0.0 scores "
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
    data = make_batch(2 * CHECK_B, g, "cpu")  # the stage's batch of 32 takes all 8 rows
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
        with count_by_shape() if name == "card" else contextlib.nullcontext():
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
    phase(6, f"{label} train step at full width, B={cpu_batch.speech_spec.shape[0]}, seed {seed}: launches "
             f"{launches}; codes differ on "
             f"{mism} tie rows (gap {gap}); loss card {m_card['loss']} vs CPU {m_cpu['loss']} vs float64 "
             f"{loss64.item()}; metrics within rtol {LOSS_RTOL}; {len(b_cpu)} EMA buffers agree; gradients "
             f"bitwise equal over two card steps (with cuDNN's default algorithms "
             f"{'equal' if default_same else 'not equal'}); worst distance from float64 over each of {len(g64)} "
             f"gradients' max: " + ", ".join(f"{step} {v:.3g} ({k})" for step, (v, k) in worst.items()))
    return launches, worst, default_same


def one_step(trainer, data, cache=None):
    """Sample a batch (with its cache rows where ``cache`` is given) and take
    one train step on it."""
    if cache is None:
        return trainer.step(trainer.sample(data))
    batch, rows = trainer.sample_cached(data, cache)
    return trainer.step(batch, cache=rows)


def step_times_ms(trainer, data, cache=None, steps: int = 10, warmup: int = 3):
    """Median host-clock time of one train step (sample + loss + backward +
    Adam), synchronised before and after, after warm-up."""
    import torch

    for _ in range(warmup):
        one_step(trainer, data, cache)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(trainer, data, cache)
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


# phase 8's stages: (label, stage, cached, vq_nearest launches per train step). The codebooks
# are frozen in all four stages, so the accumulation kernel must not run in any of them.
STAGES = (("echoed", "echoed", False, 2), ("echoed cached", "echoed", True, 0), ("finetune", "finetune", False, 2),
          ("location", "location", False, 1), ("location cached", "location", True, 0),
          ("joint", "location_joint", False, 1))
STAGE_SEED = 80
# the cached echoed or location step against the uncached one on the same weights and batch: they differ by
# the last bit of the straight-through value x + (q - x)
CACHE_RTOL = 1e-5


def make_stage_task(stage: str, **kw):
    """The stage's task (``make_task``) at its defaults (location: one-hot encodings, theta/pi; joint: the
    deployed sincos head, here with the range output and a tail term), with ``kw`` as fields."""
    from acoustic_locating_vq_vae_torch.train import make_task

    if stage == "location_joint":
        kw.update(predict_radius=True, tail_weight=0.5)
    return make_task(stage, **kw)


def stage_batch(b: int, g, device):
    """make_batch with angles over (-pi, pi) and radii over (0.5, 1.5) m."""
    import torch

    data = make_batch(b, g, device)
    theta = (torch.rand(b, generator=g, device=device) * 2 - 1) * math.pi
    return data._replace(theta=theta, radius=torch.rand(b, generator=g, device=device) + 0.5)


def composite_weights(task, g):
    """A composite's state dict from ``g``, each branch's codebook made of pre-VQ latent rows of a separate
    seeded batch: the weights the echoed and finetune stages start from and the location stages read."""
    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32

    model = task.build_model(g)
    xs, xr = task.model_inputs(stage_batch(8, g, "cpu"))  # >= K = 1024 latent rows in both branches
    with full_fp32():
        latent_codebook_(model.speech_model, xs, g)
        latent_codebook_(model.rir_model, xr, g)
    return {k: v.clone() for k, v in model.state_dict().items()}


def start_stage(tr, composite, g) -> None:
    """Load the stage's starting weights into a trainer: the composite for the echoed and finetune stages;
    for the joint stage its RIR branch (seed_params) with a codebook of its own flatten's latent rows."""
    from acoustic_locating_vq_vae_torch.eval import full_fp32

    name = tr.task.name
    if name in ("echoed", "finetune"):
        tr.model.load_state_dict(composite)
    elif name == "location_joint":
        tr.model.load_state_dict(tr.task.seed_params(tr.model.state_dict(), composite))
        spec = stage_batch(8, g, "cpu").echoed_spec.to(tr.device)
        with full_fp32():
            latent_codebook_(tr.model.rir_model, tr.task.model_inputs(spec)[0], g)


def stage_branches(tr, batch) -> dict:
    """The frozen or trained VQ-VAE branches a stage's step runs, with their inputs."""
    from acoustic_locating_vq_vae_torch.dsp import znorm

    task, model = tr.task, tr.model
    if task.name == "location":
        return {"rir": (tr.frozen_rir, znorm(batch.echoed_spec, dim=1).transpose(1, 2))}
    if task.name == "location_joint":
        return {"rir": (model.rir_model, task.model_inputs(batch.echoed_spec)[0])}
    xs, xr = task.model_inputs(batch)
    return {"speech": (model.speech_model, xs), "rir": (model.rir_model, xr)}


def frozen_weights(tr) -> dict:
    """Copies of the weights the task's cache assumes constant (the echoed stage's branches)."""
    prefixes = tuple(f"{name}." for name in tr.task.cached_frozen_subtrees)
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items() if k.startswith(prefixes)}


def stage_control_grads(tr, batch, rows):
    """Gradients of the stage trainer's next step (loss and backward, no update) with TF32 allowed, on a copy
    of its model, from its jitter state and on the same batch and cache rows."""
    import torch

    ctl = copy.copy(tr)
    ctl.model = copy.deepcopy(tr.model)
    ctl.jitter_generator = torch.Generator()
    ctl.jitter_generator.set_state(tr.jitter_generator.get_state())
    with card_precision(True, True):
        ctl._loss(batch, True, rows)[0].backward()
    return {k: p.grad.detach().cpu() for k, p in ctl.model.named_parameters() if p.grad is not None}


def stage_grad_rtol(name: str) -> float:
    """Phase 8's gradient limit of a stage (see GRAD_RTOL, LOCATION_GRAD_RTOL and ECHOED_GRAD_RTOL)."""
    return {"location": LOCATION_GRAD_RTOL, "echoed": ECHOED_GRAD_RTOL}.get(name, GRAD_RTOL)


def stage_step_card_vs_cpu(label: str, task, cached: bool, composite, dev, counters, seed: int):
    """Phase 8: one train step of a composite or location stage at full width, B = task.batch_size, on the
    card and on the CPU from the same weights, batch, cache and jitter decisions, and the same step in
    float64 on the CPU as the gradient reference. Checks codes (tie rule; the CPU's cached codes exactly),
    loss and metrics (LOSS_RTOL), every gradient (GRAD_RTOL of its max from float64, LOCATION_GRAD_RTOL on
    the location stage) and that the same parameters have gradients; on a cached stage the cached loss
    against the uncached one on the card (CACHE_RTOL); on an echoed stage the branches bitwise unchanged
    over three steps. Before the card's step, a control step with TF32 allowed runs on a copy of its model;
    its distance from float64 is printed. Returns the card step's launches, which the caller checks, and
    (worst gradient distance, its parameter) of the card's step and of the TF32 control."""
    import gc

    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.train import Trainer
    from acoustic_locating_vq_vae_torch.utils import deterministic_convs

    g = torch.Generator().manual_seed(seed)
    data = stage_batch(2 * task.batch_size, g, "cpu")
    location = task.name == "location"
    cpu, card = (Trainer(task, device=d, seed=seed + 1, verbose=False, composite_params=composite if location else None)
                 for d in ("cpu", dev))
    start_stage(cpu, composite, g)
    card.model.load_state_dict(cpu.model.state_dict())
    ref = copy.copy(cpu)  # the float64 reference of the CPU's step, from the same state
    ref.model = copy.deepcopy(cpu.model).double()
    ref.frozen_rir = copy.deepcopy(cpu.frozen_rir).double() if location else None
    ref.jitter_generator = torch.Generator()
    ref.jitter_generator.set_state(cpu.jitter_generator.get_state())
    before = frozen_weights(card) if task.name == "echoed" else {}
    runs = {}
    for name, tr in (("cpu", cpu), ("card", card)):
        resident = tr.to_device(data)
        cache = tr.build_cache(resident) if cached else None
        batch, rows = tr.sample_cached(resident, cache) if cached else (tr.sample(resident), None)
        codes = {}
        with torch.no_grad(), full_fp32():
            for b, (branch, x) in stage_branches(tr, batch).items():
                z = branch.pre_vq_latent(x)
                flat = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
                codes[b] = (branch.get_latent_codes(x).flatten().cpu(), flat.cpu(),
                            branch._vq._embedding.weight.detach().cpu().clone())
        cache_gap = None
        if name == "card" and cached:
            state = tr.jitter_generator.get_state()
            with torch.no_grad(), full_fp32(), deterministic_convs():
                losses = []
                for c in (None, rows):
                    losses.append(float(tr._loss(batch, True, c)[0]))
                    tr.jitter_generator.set_state(state)
            cache_gap = abs(losses[1] - losses[0]) / abs(losses[0])
            if not cache_gap <= CACHE_RTOL:
                raise AssertionError(f"{label}: cached loss {losses[1]} vs uncached {losses[0]} on the card, "
                                     f"rtol {CACHE_RTOL}")
        if name == "card":
            tf32 = stage_control_grads(tr, batch, rows)
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
        with count_by_shape() if name == "card" else contextlib.nullcontext():
            metrics = tr.step(batch, cache=rows)
        if name == "card":
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
        else:
            cpu_batch, cpu_rows = batch, rows
        grads = {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters() if p.grad is not None}
        rows_cpu = {k: v.cpu() for k, v in rows.items()} if cached else {}
        runs[name] = (codes, {k: float(v) for k, v in metrics.items()}, grads, rows_cpu, cache_gap)
    (codes_cpu, m_cpu, g_cpu, rows_cpu, _), (codes_card, m_card, g_card, rows_card, cache_gap) = runs["cpu"], runs["card"]
    report = []
    for b, (c_cpu, flat, cb) in codes_cpu.items():
        mism, gap = check_codes(flat, cb, codes_card[b][0], c_cpu, f"{label} {b} codes card vs CPU")
        report.append(f"{b} {mism} tie rows (gap {gap})")
        key = f"{b}_codes"
        if key in rows_cpu:
            if not torch.equal(rows_cpu[key].flatten().long(), c_cpu.long()):
                raise AssertionError(f"{label}: the CPU's cached {b} codes differ from its uncached ones")
            mism, _ = check_codes(flat, cb, rows_card[key].flatten(), c_cpu, f"{label} {b} cached codes card vs CPU")
            report.append(f"cached {b} {mism} tie rows")
    for k, v in m_cpu.items():
        if not math.isfinite(m_card[k]) or abs(m_card[k] - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f"{label}: {k} card {m_card[k]} vs CPU {v}, rtol {LOSS_RTOL}")

    batch64 = cpu_batch.map(lambda a: a.double() if a.is_floating_point() else a)
    loss64, _ = ref._loss(batch64, True, cpu_rows)
    loss64.backward()
    g64 = {k: p.grad.detach() for k, p in ref.model.named_parameters() if p.grad is not None}
    if not set(g64) == set(g_card) == set(g_cpu):
        raise AssertionError(f"{label}: parameters with a gradient differ: card {sorted(set(g_card) ^ set(g64))}, "
                             f"CPU {sorted(set(g_cpu) ^ set(g64))} from float64")
    def distance(grads):
        return max((float((grads[k].double() - r).abs().max() / r.abs().max()), k) for k, r in g64.items())

    worst, worst_cpu, worst_tf32 = distance(g_card), distance(g_cpu)[0], distance(tf32)
    limit = stage_grad_rtol(task.name)
    if worst[0] > limit:
        raise AssertionError(f"{label}: the gradient of {worst[1]} is {worst[0]} of its max from float64, "
                             f"limit {limit}")
    steps = 1
    if task.name == "echoed":  # the condition the cache rests on: Adam leaves the frozen branches as they were
        resident = card.to_device(data)
        cache = card.build_cache(resident) if cached else None
        for _ in range(2):
            one_step(card, resident, cache)
            steps += 1
        changed = [k for k, v in frozen_weights(card).items() if not torch.equal(v, before[k])]
        if changed:
            raise AssertionError(f"{label}: frozen branch weights changed over {steps} card steps: {changed[:5]}")
    phase(8, f"{label} train step at full width, B={task.batch_size}, seed {seed}: launches {launches}; codes "
             f"card vs CPU: {'; '.join(report)}; loss card {m_card['loss']} vs CPU {m_cpu['loss']} vs float64 "
             f"{loss64.item()}; metrics within rtol {LOSS_RTOL}; {len(g64)} trained parameters, worst distance "
             f"from float64 over the gradient's max (limit {limit}): card {worst[0]:.3g} ({worst[1]}), CPU "
             f"{worst_cpu:.3g}, TF32 control on the card {worst_tf32[0]:.3g} ({worst_tf32[1]})"
             + (f"; cached vs uncached loss on the card rtol {cache_gap:.3g}" if cached else "")
             + (f"; branches bitwise unchanged over {steps} card steps" if task.name == "echoed" else ""))
    del cpu, card, ref, runs, tf32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, worst, worst_tf32


def stage_phase(composite, dev, counters) -> None:
    """Phase 8: every composite and location stage's step card vs CPU (``stage_step_card_vs_cpu``), the echoed
    and finetune stages at the three GRAD_SEEDS, and each stage's TF32 control shown to fail its limit."""
    stage_worst = {}
    for label, stage, cached, nearest in STAGES:
        task = make_stage_task(stage, batch_size=CHECK_B)
        # the echoed and finetune stages at the three GRAD_SEEDS (ECHOED_GRAD_RTOL's readings), the others at one
        for seed in GRAD_SEEDS if stage in ("echoed", "finetune") else (STAGE_SEED,):
            got, worst, worst_tf32 = stage_step_card_vs_cpu(label, task, cached, composite, dev, counters, seed)
            want = {"nearest_indices_cuda": nearest, "codebook_grad_cuda": 0, "codebook_stats_cuda": 0}
            if got != want:
                raise AssertionError(f"{label} train step launched {got}, want {want}")
            stage_worst.setdefault(label, []).append((worst, worst_tf32))
    bites = []
    for label, stage, _, _ in STAGES:
        limit = stage_grad_rtol(make_stage_task(stage).name)
        missed = [t[0] for _, t in stage_worst[label] if t[0] <= limit]
        if missed:
            raise AssertionError(f"{label}: the TF32 control step reads {missed}, within the stage's limit {limit}: "
                                 "the check would not catch a TF32 leak")
        bites.append(f"{label} TF32 {min(t[0] for _, t in stage_worst[label]):.3g} > {limit}")
    phase(8, f"worst gradient distance from float64 over each gradient's max, card step | TF32 control, per seed "
             f"(limit {LOCATION_GRAD_RTOL} for the location stage, {ECHOED_GRAD_RTOL} for the echoed stage, "
             f"{GRAD_RTOL} for the others): "
             + ", ".join(f"{label} " + " / ".join(f"{w[0]:.3g} | {t[0]:.3g}" for w, t in runs)
                         for label, runs in stage_worst.items())
             + "; every TF32 control fails its stage's limit, so each check bites: " + ", ".join(bites))


def time_stage(label: str, task, cached: bool, composite, dev, counters, card: str) -> dict:
    """Phase 9: the stage's train step at its own batch size on the card (median of step_times_ms), the
    cache build where cached (ms per sample, the second of two builds), peak memory, the vq_nearest
    launches of the timed run and a torch.profiler breakdown of the step."""
    import gc

    import torch
    from acoustic_locating_vq_vae_torch.train import Trainer

    g = torch.Generator(device=dev).manual_seed(9)
    location = task.name == "location"
    tr = Trainer(task, device=dev, seed=9, verbose=False, composite_params=composite if location else None)
    start_stage(tr, composite, torch.Generator().manual_seed(9))
    data = stage_batch(2 * task.batch_size, g, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache, build = None, ""
    if cached:
        tr.build_cache(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = tr.build_cache(data)
        torch.cuda.synchronize()
        n = int(data.echoed_spec.shape[0])
        build_ms = (time.perf_counter() - t0) * 1e3
        build = f"; cache build {build_ms / n:.4f} ms per sample ({n} samples in chunks of {min(n, max(task.batch_size, 8))})"
    for c in counters:
        c.launches = 0
    with count_by_shape():
        med, times = step_times_ms(tr, data, cache=cache)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b = task.batch_size
    phase(9, f"{label} train step at B={b}, full width, TF32 off: median {med:.4f} ms over {len(times)} steps "
             f"(min {min(times):.4f}, max {max(times):.4f}), {b * 500 / med * 1e3:.1f} frames/s{build}; peak memory "
             f"{peak_gb:.3f} GB; launches over the {len(times) + 3} steps {launches} ({card})")
    wall_us, busy_us, top = device_breakdown(lambda d: one_step(tr, d, cache), [data] * 3, top=8)
    if busy_us == 0:
        phase(9, f"{label} step: the profiler recorded no device time")
    else:
        tops = "; ".join(f"{k[:70]} x{c} {t / 3 / 1e3:.3f} ms ({t / busy_us:.1%})" for k, c, t in top)
        phase(9, f"{label} step profiled, per step: {wall_us / 3 / 1e3:.4f} ms host clock, card busy "
                 f"{busy_us / 3 / 1e3:.4f} ms ({busy_us / wall_us:.1%}); kernels by device time: {tops}")
    if label == "location":  # the compat location trainer: fc_1 of 843 MB and its two Adam moments
        nbytes, save_ms, restore_ms = checkpoint_ms(tr, PIPE_ROOT / "location_store")
        saves = task.num_updates // task.ckpt_every
        phase(9, f"{label} checkpoint at step {tr.step_count}: {nbytes} bytes, save_checkpoint {save_ms:.1f} ms, "
                 f"restore_latest {restore_ms:.1f} ms; at ckpt_every = {task.ckpt_every}, {saves} saves in a "
                 f"{task.num_updates}-update stage of {task.num_updates * med / 1e3:.1f} s at this step time: "
                 f"{saves * save_ms / (task.num_updates * med):.2%} of the stage ({card})")
    del tr, data, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": med, "launches": launches, "steps": len(times) + 3}


def checkpoint_ms(tr, store_dir: Path):
    """One save_checkpoint and one restore_latest of the trainer in a fresh store at ``store_dir`` (deleted
    after): (bytes of the stage file, save ms, restore ms), host clock between synchronises."""
    import torch
    from acoustic_locating_vq_vae_torch.utils import StageStore

    shutil.rmtree(store_dir, ignore_errors=True)
    tr.store = StageStore(str(store_dir))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(f"{tr.task.name}_{tr.step_count}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tr.restore_latest() != tr.step_count:
            raise AssertionError(f"{tr.task.name}: restore_latest did not restore step {tr.step_count}")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nbytes = (store_dir / "stages" / f"{tr.task.name}_{tr.step_count}" / "state.pt").stat().st_size
    finally:
        tr.store = None
        shutil.rmtree(store_dir, ignore_errors=True)
    return nbytes, (t1 - t0) * 1e3, (t2 - t1) * 1e3


# ------------------------------------------------------------------ phase 10: the pipeline


@contextlib.contextmanager
def stage_clocks(counters):
    """While open, every ``Trainer.step``, ``build_cache`` and ``save_checkpoint`` and every stage of the
    pipeline (``pipeline.run_stage``) is timed by the host clock between synchronises, and each stage's
    kernel launches are counted; yields {stage: {what: [ms, ...], "launches": {kernel: n}}}."""
    import torch
    from acoustic_locating_vq_vae_torch.train import loop, pipeline

    clocks = collections.defaultdict(lambda: collections.defaultdict(list))

    def timed(fn, what):
        def call(*args, **kw):
            name = args[0].name if what == "stage" else args[0].task.name
            torch.cuda.synchronize()
            before = [c.launches for c in counters]
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            clocks[name][what].append((time.perf_counter() - t0) * 1e3)
            if what == "stage":
                clocks[name]["launches"] = {c.__name__: c.launches - b for c, b in zip(counters, before)}
            return out
        return call

    trainer = loop.Trainer
    saved = (trainer.step, trainer.build_cache, trainer.save_checkpoint, pipeline.run_stage)
    trainer.step, trainer.build_cache = timed(saved[0], "step"), timed(saved[1], "cache")
    trainer.save_checkpoint, pipeline.run_stage = timed(saved[2], "save"), timed(saved[3], "stage")
    try:
        yield clocks
    finally:
        trainer.step, trainer.build_cache, trainer.save_checkpoint, pipeline.run_stage = saved


def pipeline_argv(store: Path, *extra) -> list:
    """The pipeline CLI's flags in phase 10: no --data-dir, so both sets are synthesized on the card from
    --seed. Run A parses the same flags in process (``cli.run_pipeline.load_datasets``), so its data is the
    CLI's."""
    return ["--dataset-size", str(PIPE_ROWS["train"]), "--val-size", str(PIPE_ROWS["val"]), "--store-dir", str(store),
            "--updates", str(PIPE_UPDATES), "--seed", str(PIPE_SEED), "--preset", "fixed", "--joint-location",
            "--predict-radius", "--tail-weight", "0.5", "--cache-frozen", "--ckpt-every", str(PIPE_CKPT_EVERY),
            "--keep-checkpoints", "1", "--width-scale", str(PIPE_WIDTH), "--device", DEVICE, *extra]


def pipeline_cli(argv: list, log: Path):
    """Start the pipeline CLI with ``argv`` (phase 10's ``pipeline_argv``, phase 12's ``recipe_argv``), its
    output into ``log``."""
    cmd = [sys.executable, "-u", "-m", "acoustic_locating_vq_vae_torch.cli.run_pipeline", *argv]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONIOENCODING="utf-8")
    with open(log, "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env, cwd=REPO)


def terminate_when(argv: list, log: Path, store: Path, ready, what: str):
    """Run the pipeline CLI with ``argv``, and send it a real SIGTERM once ``ready`` holds of the tags in
    ``store``'s manifest. Returns (exit code, ms from the signal to the exit, the log)."""
    proc = pipeline_cli(argv, log)
    try:
        deadline = time.monotonic() + 600
        while not ready(manifest_tags(store)):
            if proc.poll() is not None:
                raise AssertionError(f"{what} exited {proc.returncode} before the signal:\n"
                                     + log.read_text(encoding="utf-8")[-3000:])
            if time.monotonic() > deadline:
                raise AssertionError(f"{what} never reached the point of the signal")
            time.sleep(0.005)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        return rc, (time.perf_counter() - t_sig) * 1e3, log.read_text(encoding="utf-8")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_cli(argv: list, log: Path):
    """Run the pipeline CLI with ``argv`` to its end; returns (exit code, the log)."""
    proc = pipeline_cli(argv, log)
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, log.read_text(encoding="utf-8")


def manifest_tags(store: Path) -> set:
    try:
        return set(json.loads((store / "manifest.json").read_text()))
    except FileNotFoundError:
        return set()


def assert_bitwise(got, want, path: str) -> None:
    """Bitwise equality of nested dicts / lists of tensors and numbers."""
    import torch

    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys differ: {sorted(set(got) ^ set(want))[:5]}")
        for k in want:
            assert_bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: lengths {len(got)} and {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            assert_bitwise(a, b, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not (got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)):
            diff = (got.double() - want.double()).abs().max() if got.shape == want.shape else "shape"
            raise AssertionError(f"{path}: not bitwise equal (max |difference| {diff})")
    elif got != want:
        raise AssertionError(f"{path}: {got} != {want}")


def pipeline_phase(dev, counters, card: str, compute_dtype: str = "float32", ph: int = 10) -> None:
    """Phase 10 (and 13 (d) with ``compute_dtype="bfloat16"``, printed as phase ``ph``): the six-stage
    pipeline at full width on the card, through its entry points, on sets
    synthesized on the card from PIPE_SEED as the CLI synthesizes them. Run A calls run_pipeline in this
    process (preset fixed, the joint stage with the range output and a tail term, the
    frozen-latent cache, PIPE_UPDATES updates a stage, a checkpoint every PIPE_CKPT_EVERY, the newest
    periodic one kept); run B runs the CLI with the same configuration in a subprocess and sends it a real
    SIGTERM in the echoed stage; run C reruns the CLI with --resume. Checks the store's six finals, their
    steps and metadata, the launches per stage, the evaluations, exit 75, the skipped stages and that run
    C's finals (weights, Adam, step, generators) are bitwise run A's, so the three processes synthesized the
    same data. Prints per stage the wall time, step
    time, cache build, checkpoint bytes, save and restore ms and the share of the wall time outside
    Trainer.step; writes a profiler trace of one stage. Deletes its directory at the end."""
    import torch
    from acoustic_locating_vq_vae_torch.cli.run_pipeline import build_parser, load_datasets
    from acoustic_locating_vq_vae_torch.eval import evaluate_joint_location, evaluate_location
    from acoustic_locating_vq_vae_torch.train import Trainer, make_task, run_pipeline, run_stage, stage_seed
    from acoustic_locating_vq_vae_torch.utils import StageStore

    t_phase = time.perf_counter()
    root = PIPE_ROOT / f"pipeline_{compute_dtype}"
    shutil.rmtree(root, ignore_errors=True)
    store_a, store_b = root / "store_a", root / "store_b"
    argv = lambda store, *extra: pipeline_argv(store, "--compute-dtype", compute_dtype, *extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, train, val = load_datasets(build_parser().parse_args(argv(store_a)))
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    for name, data in (("train", train), ("val", val)):
        n = PIPE_ROWS[name]
        if data.speech_spec.shape != (n, cfg.num_freq, cfg.num_frames) or data.speech_spec.device.type != torch.device(DEVICE).type \
                or not all(bool(torch.isfinite(a.float()).all()) for a in data):
            raise AssertionError(f"run A: synthesized {name} set {tuple(data.speech_spec.shape)} on "
                                 f"{data.speech_spec.device}, want ({n}, 201, 500) on the card, all finite")
    stages = ("speech", "rir", "echoed", "finetune", "location", "location_joint")
    want_meta = {
        "speech": {}, "rir": {}, "echoed": {}, "finetune": {},
        "location": {"input_mode": "quantized", "target_mode": "normalized_angle"},
        "location_joint": {"target_mode": "sincos", "predict_radius": True},
    }

    # ---- run A, in this process
    for c in counters:
        c.launches = 0
    with count_by_shape(), stage_clocks(counters) as clocks:
        res = run_pipeline(
            PIPE_SEED, train, val, store_dir=str(store_a), config=cfg, width_scale=PIPE_WIDTH, preset="fixed",
            joint_location=True, compute_dtype=compute_dtype,
            predict_radius=True, joint_task_kwargs={"tail_weight": 0.5}, updates={s: PIPE_UPDATES for s in stages},
            ckpt_every=PIPE_CKPT_EVERY, keep_checkpoints=1, cache_frozen=True, device=dev, verbose=False,
        )
        torch.cuda.synchronize()
        run_launches = {c.__name__: c.launches for c in counters}
        evals = {
            "location": evaluate_location(manifest_task("location", cfg, compute_dtype), res["location"][0],
                                          res["finetune"][0], val, device=dev),
            "joint": evaluate_joint_location(manifest_task("location_joint", cfg, compute_dtype),
                                             res["location_joint"][0], val, device=dev),
        }
    manifest = StageStore(str(store_a)).stages()
    for s in stages:
        meta = manifest[s]["metadata"]
        want = {"task": s, "final": True, "has_rng": True, "compat_vq_flatten": False, **want_meta[s]}
        if manifest[s]["step"] != PIPE_UPDATES or meta != want:
            raise AssertionError(f"run A: final {s} at step {manifest[s]['step']} with {meta}, want step "
                                 f"{PIPE_UPDATES} with {want}")
        periodic = [t for t in manifest if re.fullmatch(f"{s}_[0-9]+", t)]
        if len(periodic) > 1:
            raise AssertionError(f"run A: {s} keeps {periodic}, want at most one periodic tag")
        got = clocks[s]["launches"]
        accum = got["codebook_grad_cuda"] + got["codebook_stats_cuda"]
        if got["nearest_indices_cuda"] < 1 or (accum > 0) != (s in ("speech", "rir")):
            raise AssertionError(f"run A: {s} launched {got}: vq_nearest in every stage, the accumulation in "
                                 f"speech and rir only")
    for name, metrics in evals.items():
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["num_samples"] != PIPE_ROWS["val"]:
            raise AssertionError(f"run A: {name} evaluation {metrics}")
    phase(ph, f"run A, run_pipeline ({compute_dtype}) in process on sets synthesized on the card from seed {PIPE_SEED} "
              f"({PIPE_ROWS['train']} + {PIPE_ROWS['val']} rows in {synth_s:.2f} s, load_datasets as the CLI), "
              f"full width, preset fixed, joint stage with radius and tail term, cache on, {PIPE_UPDATES} updates a stage, a checkpoint every {PIPE_CKPT_EVERY}, keep 1: six "
              f"finals at step {PIPE_UPDATES} with their tasks' metadata, at most one periodic tag a stage; "
              f"launches {run_launches}, by stage "
              + "; ".join(f"{s} {clocks[s]['launches']}" for s in stages)
              + "; evaluations on the synthesized validation rows: " + "; ".join(
                  f"{name} median {m['median_abs_radians']:.4f} rad, coordinates RMSE {m['rmse_coordinates_m']:.4f} m"
                  + (f", radius RMSE {m['rmse_radius_m']:.4f} m" if "rmse_radius_m" in m else "")
                  for name, m in evals.items()))

    # restore_latest of each stage's newest periodic checkpoint into a fresh trainer
    restore_ms = {}
    for i, s in enumerate(stages):
        task = manifest_task(s, cfg, compute_dtype)
        tr = Trainer(task, device=dev, seed=stage_seed(PIPE_SEED, i), verbose=False, checkpoint_dir=str(store_a),
                     composite_params=res["finetune"][0] if s == "location" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tr.restore_latest() != PIPE_UPDATES:
            raise AssertionError(f"{s}: restore_latest did not find step {PIPE_UPDATES}")
        torch.cuda.synchronize()
        restore_ms[s] = (time.perf_counter() - t0) * 1e3
        del tr
    torch.cuda.empty_cache()

    # one stage with profile_dir: a trace of steps 2 to 7
    profile_dir = root / "profile"
    run_stage(manifest_task("rir", cfg, compute_dtype), stage_seed(PIPE_SEED, 1), train, None, num_updates=PIPE_UPDATES,
              device=dev, verbose=False, profile_dir=str(profile_dir))
    events = json.loads((profile_dir / "rir.json").read_text())["traceEvents"]
    kernel_events = sum(e.get("cat") == "kernel" for e in events)
    if not events:
        raise AssertionError("profile_dir wrote an empty trace")
    phase(ph, f"run_stage(rir, profile_dir=...) wrote {profile_dir / 'rir.json'}: {len(events)} events, "
              f"{kernel_events} of them kernels on the card")

    # ---- run B: the CLI in a subprocess, a real SIGTERM in the echoed stage
    rc, sigterm_ms, log_b = terminate_when(
        argv(store_b), root / "run_b.log", store_b,
        lambda tags: any(re.fullmatch("echoed_[0-9]+", t) for t in tags) and "echoed" not in tags, "run B")
    tags = manifest_tags(store_b)
    echoed_tags = sorted(t for t in tags if re.fullmatch("echoed_[0-9]+", t))
    if rc != 75 or "[preempted]" not in log_b or "echoed" in tags or len(echoed_tags) != 1 \
            or not {"speech", "rir"} <= tags:
        raise AssertionError(f"run B: exit {rc}, store {sorted(tags)}; want exit 75, the speech and rir finals, "
                             f"one echoed periodic tag and no echoed final:\n{log_b[-3000:]}")
    preempted_at = int(echoed_tags[0].split("_")[1])

    # ---- run C: the CLI with --resume
    rc, log_c = run_cli(argv(store_b, "--resume"), root / "run_c.log")
    expected = ["[pipeline] stage 'speech' complete in store — skipping",
                "[pipeline] stage 'rir' complete in store — skipping", f"[echoed] resumed at step {preempted_at}",
                "joint location evaluation"]
    missing = [line for line in expected if line not in log_c]
    if rc != 0 or missing:
        raise AssertionError(f"run C: exit {rc}, missing {missing}:\n{log_c[-3000:]}")
    a, c = StageStore(str(store_a)), StageStore(str(store_b))
    for s in stages:
        assert_bitwise(c.load_stage(s), a.load_stage(s), f"run C's final {s} against run A's")
    phase(ph, f"run B, the CLI with the same configuration, its sets synthesized from --seed: SIGTERM once the store showed a periodic echoed "
              f"tag, exit 75 {sigterm_ms:.1f} ms after the signal, the store holds {echoed_tags[0]} and no echoed "
              f"final; run C, the CLI with --resume: speech and rir skipped, echoed resumed at step "
              f"{preempted_at}; every stage's final (weights, Adam state, step, both generators; the joint "
              f"head included) bitwise equal to run A's, so three processes synthesized the same sets")

    # ---- timings of run A
    parts = []
    for s in stages:
        k = clocks[s]
        wall, steps = k["stage"][0], sum(k["step"])
        step_ms = statistics.median(k["step"])
        nbytes = (store_a / "stages" / s / "state.pt").stat().st_size
        save_ms = statistics.mean(k["save"])
        task = make_task(s)
        parts.append(
            f"{s}: wall {wall:.1f} ms, step median {step_ms:.2f} ms (B={task.batch_size}), cache build "
            f"{sum(k['cache']):.1f} ms, checkpoint {nbytes} bytes, save {save_ms:.1f} ms (mean of {len(k['save'])}), "
            f"restore {restore_ms[s]:.1f} ms, {(wall - steps) / wall:.1%} of the wall time outside Trainer.step; "
            f"at ckpt_every {task.ckpt_every}, a save costs {save_ms / (task.ckpt_every * step_ms):.2%} of the "
            f"steps between two saves")
    phase(ph, f"run A ({compute_dtype}) per stage: " + " | ".join(parts) + f"; the pipeline took "
              f"{time.perf_counter() - t_phase:.1f} s ({card})")
    shutil.rmtree(root)


# ------------------------------------------------------------------ phase 11: synthesis


def head_draws(draws, k: int):
    """The first ``k`` samples of a SynthDraws."""
    return type(draws)(*(a[:k] if hasattr(a, "shape") else a for a in draws))


def max_rel(got, want) -> float:
    """max |got - want| over max |want|, in float64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def ratio_shape_err(got, want, echoed) -> tuple:
    """rir_spec against a reference with each sample's scale divided out: the
    max-normalization divides by |speech/echoed| at the bin of the smallest
    echoed power (1e-9 of the median in some samples), so float32 rounding
    of that one bin sets the sample's scale. Per sample: the median ratio
    over the bins whose echoed power exceeds 1e-3 of its max, then the
    largest relative difference there. Returns (that difference, the
    scales)."""
    got, want, echoed = (a.detach().double().cpu() for a in (got, want, echoed))
    errs, scales = [], []
    for b in range(got.shape[0]):
        mask = echoed[b] >= 1e-3 * echoed[b].max()
        scale = float((got[b][mask] / want[b][mask]).median())
        errs.append(float(((got[b][mask] - scale * want[b][mask]).abs() / (scale * want[b][mask]).abs()).max()))
        scales.append(scale)
    return max(errs), scales


def sync_times_ms(fn, steps: int = 10, warmup: int = 2):
    """Median host-clock time of ``fn()`` between synchronises, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def synthesis_phase(dev, card: str) -> None:
    """Phase 11: synthesis at the full geometry (201 x 500, 6400-tap RIRs over 179,443 lattice images) on the
    card: at three seeds a B = 64 batch against the port in float64 on the CPU from the same draws (its first
    SYNTH_CHECK_B rows), the speech's float32 phase drift, bitwise repeats, every option once, and the
    timings."""
    import torch
    from acoustic_locating_vq_vae_torch import data
    from acoustic_locating_vq_vae_torch.data import speech
    from acoustic_locating_vq_vae_torch.data.synth import add_sensor_noise
    from acoustic_locating_vq_vae_torch.dsp import fft_convolve, generate_rir_batch, source_coordinates
    from acoustic_locating_vq_vae_torch.dsp.rir import _chunked_lattice

    t_phase = time.perf_counter()
    cfg = data.DatasetConfig()
    boxes = dict(zip(("source_box", "receiver_box"), data.geometry_boxes(cfg, cfg.R)))
    rir_kw = dict(room=tuple(cfg.room_dimensions), nsample=cfg.n_sample, fs=float(cfg.fs), c=cfg.c,
                  rt60=cfg.reverberation_time, chunk=SYNTH_CHUNK, **boxes)
    images = int((_chunked_lattice(rir_kw["room"], cfg.n_sample, rir_kw["fs"], cfg.c, True, boxes["source_box"],
                                   boxes["receiver_box"], SYNTH_CHUNK)[0][..., 3] >= 0).sum())
    if images != SYNTH_IMAGES:
        raise AssertionError(f"the boxed lattice holds {images} images, want {SYNTH_IMAGES}")

    # ---- the card against the port in float64 on the CPU, same draws
    worst = collections.defaultdict(float)
    scales = []
    drift = collections.defaultdict(float)
    for seed in SYNTH_SEEDS:
        draws = data.draw_synthesis(torch.Generator(dev).manual_seed(seed), SYNTH_B, cfg)
        got = data.synthesize_from_draws(draws, cfg)
        h = data.rirs_from_draws(draws, cfg)
        ref_draws = head_draws(draws, SYNTH_CHECK_B).to("cpu", torch.float64)
        ref = data.synthesize_from_draws(ref_draws, cfg)
        h_ref = data.rirs_from_draws(ref_draws, cfg)
        k = SYNTH_CHECK_B
        if got.speech_spec.shape != (SYNTH_B, 201, 500) or got.wiener_est.shape != (SYNTH_B, 201) \
                or not all(bool(torch.isfinite(a.float()).all()) for a in got):
            raise AssertionError(f"seed {seed}: batch of shape {tuple(got.speech_spec.shape)}, want (64, 201, 500), "
                                 "all finite")
        errs = {"rir": max_rel(h[:k], h_ref)}
        for name in ("speech_spec", "echoed_spec", "wiener_est"):
            errs[name] = max_rel(getattr(got, name)[:k], getattr(ref, name))
        errs["rir_spec"], sc = ratio_shape_err(got.rir_spec[:k], ref.rir_spec, ref.echoed_spec)
        scales += sc
        for name, e in errs.items():
            worst[name] = max(worst[name], e)
        # the speech's float32 phase (a cumulative sum of f0 over 80,000 samples), card against the CPU
        sd = speech.speech_draws(torch.Generator(dev).manual_seed(seed), SYNTH_CHECK_B, cfg.audio_samples, cfg.fs)
        on_card = speech.speech_from_draws(sd).cpu().double()
        cpu32 = speech.speech_from_draws(speech.SpeechDraws(*(a.cpu() for a in sd))).double()
        cpu64 = speech.speech_from_draws(speech.SpeechDraws(*(a.cpu().double() for a in sd)))
        for name, (a, b) in {"card - CPU f32": (on_card, cpu32), "card - CPU f64": (on_card, cpu64),
                             "CPU f32 - CPU f64": (cpu32, cpu64)}.items():
            drift[name] = max(drift[name], float((a - b).abs().max()))
        del got, h, draws
    bad = {name: e for name, e in worst.items() if e > SYNTH_LIMITS[name]}
    phase(11, f"card vs the port in float64 on the CPU from the same draws, full geometry, B={SYNTH_B} on the card, "
              f"its first {SYNTH_CHECK_B} rows on the CPU, seeds {SYNTH_SEEDS}: worst max|error| / max|float64| "
              + ", ".join(f"{name} {e:.3g} (limit {SYNTH_LIMITS[name]:g})" for name, e in worst.items())
              + f" (rir_spec after each sample's scale; the scales card/float64 span {min(scales):.4f} to "
              f"{max(scales):.4f}); unit-peak speech from the same draws, max |difference| "
              + ", ".join(f"{name} {e:.3g}" for name, e in drift.items()))
    if bad:
        raise AssertionError(f"card vs CPU float64 above the limits: {bad}")

    # ---- bitwise repeats
    runs = [data.synthesize_batch(torch.Generator(dev).manual_seed(SYNTH_SEEDS[0]), SYNTH_B, cfg, device=dev)
            for _ in range(2)]
    for name, a, b in zip(data.SampleBatch._fields, *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"two synthesize_batch runs from equal generators differ in {name}")
    receiver = torch.tensor(cfg.receiver_position, device=dev)
    sources = source_coordinates(runs[0].theta, receiver, torch.tensor(cfg.room_dimensions, device=dev),
                                 z_loc=cfg.Z_LOC_SOURCE)
    rirs = [generate_rir_batch(sources, receiver, **rir_kw) for _ in range(2)]
    if not torch.equal(*rirs):
        raise AssertionError("two generate_rir_batch runs differ")
    del runs, rirs

    # ---- every option once, B = 16
    b16 = 16
    gen = lambda: torch.Generator(dev).manual_seed(SYNTH_SEEDS[1])  # noqa: E731
    report = []
    d = data.draw_synthesis(gen(), b16, cfg, rt60_range=(0.2, 0.8), radius_range=(0.5, 1.4))
    batch = data.synthesize_from_draws(d, cfg)
    if not (0.2 <= float(d.rt60.min()) and float(d.rt60.max()) <= 0.8 and 0.5 <= float(d.radius.min())
            and float(d.radius.max()) <= 1.4 and torch.equal(batch.radius, d.radius)
            and bool(torch.isfinite(batch.echoed_spec).all())):
        raise AssertionError("rt60_range / radius_range: draws out of range or a non-finite batch")
    report.append(f"rt60_range (0.2, 0.8) and radius_range (0.5, 1.4): T60 {float(d.rt60.min()):.3f}-"
                  f"{float(d.rt60.max()):.3f} s, radius {float(d.radius.min()):.3f}-{float(d.radius.max()):.3f} m")
    d = data.draw_synthesis(gen(), b16, cfg, snr_range=(5.0, 25.0), snr_clean_prob=0.25)
    noisy = data.synthesize_from_draws(d, cfg)
    quiet = data.synthesize_from_draws(d._replace(snr_db=None, noise=None, clean=None), cfg)
    # the echoed waveform the batch was made from, rebuilt from the same draws
    echoed = fft_convolve(d.speech, data.rirs_from_draws(d, cfg), mode="same")
    wave = add_sensor_noise(echoed, d.snr_db, d.noise, d.clean)
    clean = d.clean
    snr = 10 * (echoed.double().square().mean(1) / (wave - echoed).double().square().mean(1)).log10()
    snr_err = (snr[~clean] - d.snr_db[~clean].double()).cpu()
    if not torch.equal(noisy.echoed_spec, data.observed_power_spec(wave, cfg)) \
            or not torch.equal(noisy.speech_spec, quiet.speech_spec) or int(clean.sum()) in (0, b16) \
            or not torch.equal(noisy.echoed_spec[clean], quiet.echoed_spec[clean]) \
            or torch.equal(noisy.echoed_spec[~clean], quiet.echoed_spec[~clean]) \
            or float(snr_err.abs().max()) > SNR_TOL_DB:
        raise AssertionError(f"snr_range: {int(clean.sum())} clean samples, measured - drawn SNR "
                             f"{snr_err.tolist()} dB (limit {SNR_TOL_DB})")
    report.append(f"snr_range (5, 25) dB with snr_clean_prob 0.25: the noisy batch's echoed spectrogram bitwise "
                  f"that of its echoed waveform plus sensor noise, {int(clean.sum())} clean samples bitwise the "
                  f"noiseless batch, the others' SNR measured on the waveform within "
                  f"{float(snr_err.abs().max()):.4f} dB of the drawn (limit {SNR_TOL_DB})")
    fixed = data.synthesize_batch(gen(), b16, cfg, fixed_rir=True, fixed_speech=True, device=dev)
    for name in ("speech_spec", "echoed_spec", "rir_spec", "theta"):
        t = getattr(fixed, name)
        if not torch.equal(t, t[:1].expand(t.shape)):
            raise AssertionError(f"fixed_rir and fixed_speech: {name} differs between samples")
    rir_only = data.synthesize_batch(gen(), b16, cfg, fixed_rir=True, device=dev)
    if not torch.equal(rir_only.theta, rir_only.theta[:1].expand(b16)) or torch.equal(
            rir_only.speech_spec[0], rir_only.speech_spec[1]):
        raise AssertionError("fixed_rir: the angle varies or the speech does not")
    report.append("fixed_rir and fixed_speech: one angle, one utterance, equal rows")
    drawn = data.synthesize_batch(gen(), b16, cfg, device=dev)
    replay = data.synthesize_batch(gen(), b16, cfg, theta=drawn.theta, radius=drawn.radius, device=dev)
    for name, a, b in zip(data.SampleBatch._fields, drawn, replay):
        if not torch.equal(a, b):
            raise AssertionError(f"given geometry: the replay of a drawn geometry differs in {name}")
    report.append("given theta and radius of a drawn batch: bitwise that batch")
    phase(11, "every option once on the card, B=16: " + "; ".join(report))
    del noisy, quiet, echoed, wave, fixed, rir_only, drawn, replay, batch

    # ---- timings
    torch.cuda.empty_cache()
    g = torch.Generator(dev).manual_seed(SYNTH_SEEDS[2])
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the peaks below count what the call adds to this
    synth_ms, synth_times = sync_times_ms(lambda: data.synthesize_batch(g, SYNTH_B, cfg, device=dev))
    synth_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    chunk_ms = {}
    for chunk in SYNTH_CHUNK_SWEEP:
        kw = dict(rir_kw, chunk=chunk)
        torch.cuda.reset_peak_memory_stats()
        ms, _ = sync_times_ms(lambda: generate_rir_batch(sources, receiver, **kw))
        chunk_ms[chunk] = (ms, (torch.cuda.max_memory_allocated() - held) / 1e9)
    rir_ms = chunk_ms[SYNTH_CHUNK][0]
    phase(11, f"synthesize_batch B={SYNTH_B}: median {synth_ms:.3f} ms over {len(synth_times)} (min "
              f"{min(synth_times):.3f}, max {max(synth_times):.3f}), {SYNTH_B / synth_ms * 1e3:.1f} samples/s, peak "
              f"memory {synth_peak:.3f} GB above what was held before; generate_rir_batch B={SYNTH_B}, chunk {SYNTH_CHUNK}: median "
              f"{rir_ms:.3f} ms, {SYNTH_B / rir_ms * 1e3:.1f} RIRs/s ({SYNTH_B * SYNTH_IMAGES / rir_ms / 1e6:.3f} G "
              f"image sources/s); by chunk, time / peak memory: "
              + ", ".join(f"{c} {ms:.3f} ms / {gb:.3f} GB" for c, (ms, gb) in chunk_ms.items()) + f" ({card})")
    wall_us, busy_us, top = device_breakdown(lambda _: data.synthesize_batch(g, SYNTH_B, cfg, device=dev), [None],
                                             top=8)
    if busy_us == 0:
        phase(11, "synthesize_batch: the profiler recorded no device time")
    else:
        tops = "; ".join(f"{kname[:60]} x{c} {t / 1e3:.3f} ms ({t / busy_us:.1%})" for kname, c, t in top)
        phase(11, f"synthesize_batch B={SYNTH_B} profiled: {wall_us / 1e3:.3f} ms host clock, card busy "
                  f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}); kernels by device time: {tops}")
    made = {}
    for size in SYNTH_DATASET_ROWS:
        gd = torch.Generator(dev).manual_seed(size)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms, times = sync_times_ms(lambda: data.make_dataset(gd, size, cfg, device=dev), steps=10, warmup=1)
        made[size] = (ms / 1e3, min(times) / 1e3, max(times) / 1e3, (torch.cuda.max_memory_allocated() - held) / 1e9)
    row_bytes = 4 * (3 * cfg.num_freq * cfg.num_frames + cfg.num_freq + 3)  # the fields of one float32 row
    n_train, n_val = SYNTH_DATASET_ROWS
    phase(11, "make_dataset on the card, batches of 32, median of 10 after a warm-up: " + "; ".join(
        f"{n} rows {s:.3f} s (min {lo:.3f}, max {hi:.3f}; {n / s:.1f} samples/s; {n * row_bytes / 1e9:.3f} GB "
        f"resident, peak {peak:.3f} GB above what was held before)" for n, (s, lo, hi, peak) in made.items())
        + f": the CLI's default sets take {made[n_train][0] + made[n_val][0]:.3f} s; phase 11 took "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")


# ------------------------------------------------------------------ phase 12: on-the-fly training


def otf_grids():
    """Run K's T60 and radius grids (np.linspace over its ranges, OTF_GRID each)."""
    import numpy as np

    return (np.linspace(*OTF_RANGES["rt60_range"], OTF_GRID), np.linspace(*OTF_RANGES["radius_range"], OTF_GRID))


def bank_phase(dev, cfg, card: str):
    """Phase 12, the bank: run K's bank (OTF_BANK_THETA angles, or 1024 with --full-bank; 8 T60s x 8 radii)
    built and timed on the card; rows of three cells bitwise equal to generate_rir_batch on the card at the
    same geometry and batch of angles, two rows of each within SYNTH_LIMITS of the port in float64 on the
    CPU. Returns the bank."""
    import warnings

    import torch
    from acoustic_locating_vq_vae_torch import data
    from acoustic_locating_vq_vae_torch.dsp import generate_rir_batch, source_coordinates

    n_theta = 1024 if FULL_BANK in sys.argv[1:] else OTF_BANK_THETA
    t60s, radii = otf_grids()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # run K's 14.3 cm radius grid draws the off-grid advisory
        bank = data.make_rir_bank(cfg, n_theta, rt60s=t60s, radii=radii, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    n_rirs = OTF_GRID * OTF_GRID * n_theta
    if tuple(bank.shape) != (OTF_GRID, OTF_GRID, n_theta, cfg.n_sample) or not bool(torch.isfinite(bank).all()):
        raise AssertionError(f"bank of shape {tuple(bank.shape)}, want {(OTF_GRID, OTF_GRID, n_theta, cfg.n_sample)}"
                             ", all finite")
    thetas = torch.from_numpy(data.bank_thetas(n_theta)).to(dev)
    receiver = torch.tensor(cfg.receiver_position).to(dev)
    room = torch.tensor(cfg.room_dimensions).to(dev)
    kw = dict(room=tuple(cfg.room_dimensions), nsample=cfg.n_sample, fs=float(cfg.fs), c=cfg.c, chunk=8192)
    rows = slice(0, min(256, n_theta))  # make_rir_bank's first batch of angles
    worst = 0.0
    for i, j in ((0, 0), (OTF_GRID - 1, OTF_GRID - 1), (3, 5)):
        r = float(radii[j])
        src = source_coordinates(thetas, receiver, room, radius=r, z_loc=cfg.Z_LOC_SOURCE)
        sbox, rbox = data.geometry_boxes(cfg, r)
        h = generate_rir_batch(src[rows], receiver, rt60=float(t60s[i]), source_box=sbox, receiver_box=rbox, **kw)
        if not torch.equal(bank[i, j, rows], h):
            raise AssertionError(f"bank cell ({i}, {j}) is not bitwise generate_rir_batch on the card")
        ref = generate_rir_batch(src[:2].double().cpu(), receiver.cpu(), rt60=float(t60s[i]), source_box=sbox,
                                 receiver_box=rbox, **kw)
        worst = max(worst, max_rel(bank[i, j, :2], ref))
    if worst > SYNTH_LIMITS["rir"]:
        raise AssertionError(f"bank rows {worst:.3g} of their max from float64, limit {SYNTH_LIMITS['rir']}")
    phase(12, f"RIR bank of run K's grid, {n_theta} angles x {OTF_GRID} T60s x {OTF_GRID} radii = {n_rirs} RIRs, "
              f"{bank.numel() * 4 / 1e9:.3f} GB: built in {build_s:.2f} s ({n_rirs / build_s:.1f} RIRs/s; run K's "
              f"1024 angles extrapolate to {build_s * 1024 / n_theta:.1f} s), peak {peak_gb:.3f} GB above what was "
              f"held; three cells bitwise generate_rir_batch on the card, rows {worst:.3g} of their max from the "
              f"port in float64 on the CPU (limit {SYNTH_LIMITS['rir']}) ({card})")
    return bank


def label_phase(dev, cfg, bank) -> None:
    """Phase 12, labels: a pure-bank and a mixed (bank_mix_prob 0.5) batch of OTF_LABEL_B on the card from run
    K's bank and options: every bank sample's labels are its gathered cell's angle and radius exactly; those
    samples synthesized exactly at their labels (given angle and radius, the cell's T60) give RIRs, spectra
    and Wiener estimates within SYNTH_LIMITS of the bank's (rir_spec with each sample's scale divided out)."""
    import torch
    from acoustic_locating_vq_vae_torch import data

    t60s, radii = otf_grids()
    t60s, radii = torch.tensor(t60s, dtype=torch.float32), torch.tensor(radii, dtype=torch.float32)
    thetas = torch.from_numpy(data.bank_thetas(bank.shape[2]))
    g = torch.Generator(dev).manual_seed(OTF_SEED)
    report = []
    for name, kw in (("pure bank", OTF_NOISE), ("mixed 0.5", dict(OTF_RANGES, **OTF_NOISE, bank_mix_prob=0.5))):
        draws = data.draw_synthesis(g, OTF_LABEL_B, cfg, rir_bank=bank, rir_bank_radii=radii, **kw)
        got = data.synthesize_from_draws(draws, cfg, rir_bank=bank)
        use = (torch.ones(OTF_LABEL_B, dtype=torch.bool) if draws.use_bank is None else draws.use_bank).cpu()
        t, r, th = draws.bank_index.cpu().unbind(1)
        if not 0 < int(use.sum()) or not torch.equal(draws.theta.cpu()[use], thetas[th[use]]) \
                or not torch.equal(draws.radius.cpu()[use], radii[r[use]]):
            raise AssertionError(f"{name}: a bank sample's labels are not its gathered cell's angle and radius")
        exact = draws._replace(rt60=t60s.to(dev)[draws.bank_index[:, 0]], bank_index=None, use_bank=None,
                               r_hi=float(radii.max()))
        again = data.synthesize_from_draws(exact, cfg)
        gathered = bank[tuple(draws.bank_index.unbind(1))]
        errs = {"rir": max_rel(gathered[use], data.rirs_from_draws(exact, cfg)[use])}
        for field in ("speech_spec", "echoed_spec", "wiener_est"):
            errs[field] = max_rel(getattr(got, field)[use], getattr(again, field)[use])
        errs["rir_spec"] = ratio_shape_err(got.rir_spec[use], again.rir_spec[use], again.echoed_spec[use])[0]
        bad = {k: v for k, v in errs.items() if v > SYNTH_LIMITS[k]}
        if bad:
            raise AssertionError(f"{name}: bank samples against exact synthesis at their labels {bad}, limits "
                                 f"{SYNTH_LIMITS}")
        report.append(f"{name}: {int(use.sum())} of {OTF_LABEL_B} samples from the bank, "
                      + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    phase(12, "labels are the gathered cell's angle and radius, bitwise; the bank samples synthesized exactly at "
              "their labels against the bank's, max |difference| / max: " + "; ".join(report))


def otf_profile(tr, steps: int = 3):
    """torch.profiler over ``steps`` on-the-fly steps, the synthesis in a ``record_function`` range: (host ms a
    step, card busy ms a step, the synthesis's card ms a step, or None if the profiler attributed none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tr.step(tr.otf_batch())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("otf_synthesis"):
                batch = tr.otf_batch()
            tr.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    synth_us = sum(e.device_time_total for e in prof.events()
                   if e.name == "otf_synthesis" and e.device_type == DeviceType.CPU)
    return wall_ms / steps, busy_us / steps / 1e3, (synth_us / steps / 1e3 if synth_us > 0 else None)


def otf_timings(dev, cfg, bank, counters, card: str) -> None:
    """Phase 12, step times: each stage's train step at its own batch size on the card, resident (a synthesized
    set of 2 B rows, sampled) and on the fly with run K's exact options, and for the joint stage also from the
    bank and mixed 0.5; medians of 10 after 3 warm-ups, host clock between synchronises, on one trainer of the
    seed of phase 9; the synthesis alone, its share of the step by the host clock and by a profile's card
    time; the kernels' launches of the timed on-the-fly steps."""
    import torch
    from acoustic_locating_vq_vae_torch import data
    from acoustic_locating_vq_vae_torch.train import Trainer

    _, radii = otf_grids()
    exact = dict(OTF_RANGES, **OTF_NOISE)
    bank_kw = dict(OTF_NOISE, rir_bank=bank, rir_bank_radii=radii.astype("float32"))
    runs = (("speech", "speech", exact), ("rir", "rir", exact), ("echoed", "echoed", exact),
            ("finetune", "finetune", exact), ("location", "location", exact), ("joint", "location_joint", exact),
            ("joint bank", "location_joint", bank_kw), ("joint mixed 0.5", "location_joint",
                                                        dict(bank_kw, **OTF_RANGES, bank_mix_prob=0.5)))
    composite = composite_weights(make_stage_task("echoed", config=cfg, width_scale=OTF_WIDTH),
                                  torch.Generator().manual_seed(STAGE_SEED))
    lines = []
    for label, stage, synth_kw in runs:
        task = make_stage_task(stage, config=cfg, width_scale=OTF_WIDTH)
        tr = Trainer(task, device=dev, seed=9, verbose=False, on_the_fly=True, synth_kwargs=synth_kw,
                     composite_params=composite if stage == "location" else None)
        start_stage(tr, composite, torch.Generator().manual_seed(9))
        resident = data.make_dataset(torch.Generator(dev).manual_seed(9), 2 * task.batch_size, cfg, device=dev,
                                     **exact)
        res_ms, _ = step_times_ms(tr, resident)
        del resident
        for c in counters:
            c.launches = 0
        with count_by_shape():
            otf_ms, times = sync_times_ms(lambda: tr.step(tr.otf_batch()), steps=10, warmup=3)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        if launches["nearest_indices_cuda"] < 13:
            raise AssertionError(f"{label}: the on-the-fly steps launched {launches}")
        synth_ms, _ = sync_times_ms(tr.otf_batch, steps=10, warmup=1)
        wall, busy, synth_card = otf_profile(tr)
        card_share = "not attributed" if synth_card is None else f"{synth_card:.3f} ms, {synth_card / busy:.1%}"
        lines.append(f"{label} B={task.batch_size}: resident {res_ms:.3f} ms, on the fly {otf_ms:.3f} ms (min "
                     f"{min(times):.3f}, max {max(times):.3f}; {otf_ms / res_ms:.2f}x), synthesis alone "
                     f"{synth_ms:.3f} ms ({synth_ms / otf_ms:.1%} of the step by the host clock); profiled: "
                     f"{wall:.3f} ms a step, card busy {busy:.3f} ms ({busy / wall:.1%}), synthesis {card_share}; "
                     f"launches over 13 steps {launches}")
        del tr
        torch.cuda.empty_cache()
    phase(12, f"train steps at full width, resident against on the fly ({card}): " + " | ".join(lines))


def recipe_argv(store: Path, *extra) -> list:
    """Phase 12's pipeline CLI: run K's first and second commands in one, at full width on the card, with a
    small bank, RECIPE_UPDATES a stage and the joint stage's first RECIPE_BANK from the bank."""
    n_theta, n_t60, n_r = RECIPE_BANK_SIZE
    return ["--on-the-fly", "--val-size", "16", "--store-dir", str(store), "--updates", str(RECIPE_UPDATES), "--seed",
            str(PIPE_SEED), "--preset", "fixed", "--joint-location", "--predict-radius", "--tail-weight", "1.0",
            "--rt60-range", *map(str, OTF_RANGES["rt60_range"]), "--radius-range", *map(str, OTF_RANGES["radius_range"]),
            "--snr-range", *map(str, OTF_NOISE["snr_range"]), "--snr-clean-prob", str(OTF_NOISE["snr_clean_prob"]),
            "--rir-bank", str(n_theta), "--rir-bank-rt60s", str(n_t60), "--rir-bank-radii", str(n_r),
            "--bank-pretrain-updates", str(RECIPE_BANK), "--ckpt-every", "2", "--keep-checkpoints", "1",
            "--width-scale", str(OTF_WIDTH), "--device", DEVICE, *OTF_CLI_EXTRA, *extra]


def recipe_phase(counters, card: str) -> None:
    """Phase 12, the recipe through the CLI: run A (the hard bank->exact switch) and run A' (--polish-bank-prob
    0.25) in this process through the CLI's main, their launches counted; then run B, A's flags in a
    subprocess, sent a real SIGTERM in the joint stage's bank leg, run C with --resume, sent a SIGTERM in the
    polish leg, and run D with --resume: every final bitwise equal to run A's. Checks the finals, the pinned leg
    boundary, the exits and the resume lines."""
    import io

    import torch
    from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli
    from acoustic_locating_vq_vae_torch.utils import StageStore

    root = PIPE_ROOT / "recipe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    stages = ("speech", "rir", "echoed", "finetune", "location", "location_joint")
    joint_tag = lambda t: int(t.rsplit("_", 1)[1]) if re.fullmatch("location_joint_[0-9]+", t) else None
    runs = {}
    for name, extra in (("A", ()), ("A'", ("--polish-bank-prob", "0.25"))):
        store = root / f"store_{name}"
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = io.StringIO()
        with count_by_shape(), contextlib.redirect_stdout(out):
            cli.main(recipe_argv(store, *extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        log = out.getvalue()
        manifest = StageStore(str(store)).stages()
        if any(manifest.get(s, {}).get("step") != RECIPE_UPDATES for s in stages) \
                or f"bank pretraining done at step {RECIPE_BANK}" not in log or "joint location evaluation" not in log \
                or launches["nearest_indices_cuda"] < 1 or launches["codebook_grad_cuda"] < 1:
            raise AssertionError(f"run {name}: finals {({s: manifest.get(s, {}).get('step') for s in stages})}, "
                                 f"launches {launches}:\n{log[-3000:]}")
        joint_eval = json.loads(log.split("joint location evaluation:", 1)[1].split("\n}", 1)[0] + "}")
        runs[name] = (store, wall, launches, joint_eval)
    phase(12, "the recipe through the CLI's main in this process, --on-the-fly --joint-location --predict-radius, "
              f"run K's ranges and noise, a {'x'.join(map(str, RECIPE_BANK_SIZE))} bank, {RECIPE_UPDATES} updates "
              f"a stage, the joint stage's first {RECIPE_BANK} from the bank: " + "; ".join(
                  f"run {n} {'hard switch' if n == 'A' else 'polish-bank-prob 0.25'}: six finals at step "
                  f"{RECIPE_UPDATES}, {wall:.1f} s, launches {launches}, joint evaluation median "
                  f"{ev['median_abs_radians']:.4f} rad, radius RMSE {ev['rmse_radius_m']:.4f} m"
                  for n, (_, wall, launches, ev) in runs.items()) + f" ({card})")

    # ---- runs B, C, D: A's flags, SIGTERM in the bank leg, then in the polish leg, then to the end
    store = root / "store_B"
    final = "location_joint"
    rc, ms_b, log_b = terminate_when(
        recipe_argv(store), root / "run_b.log", store,
        lambda tags: any(2 <= (joint_tag(t) or 0) < RECIPE_BANK for t in tags) and final not in tags, "run B")
    at_b = [joint_tag(t) for t in manifest_tags(store) if joint_tag(t)]
    if rc != 75 or "[preempted]" not in log_b or len(at_b) != 1 or not at_b[0] < RECIPE_BANK:
        raise AssertionError(f"run B: exit {rc}, joint tags {at_b}; want exit 75 inside the bank leg:\n{log_b[-3000:]}")
    rc, ms_c, log_c = terminate_when(
        recipe_argv(store, "--resume"), root / "run_c.log", store,
        lambda tags: any((joint_tag(t) or 0) >= RECIPE_BANK + 2 for t in tags) and final not in tags, "run C")
    at_c = [joint_tag(t) for t in manifest_tags(store) if joint_tag(t)]
    want_c = [f"[location_joint] resumed at step {at_b[0]}", f"bank pretraining done at step {RECIPE_BANK}"]
    if rc != 75 or any(w not in log_c for w in want_c) or len(at_c) != 1 or not at_c[0] > RECIPE_BANK:
        raise AssertionError(f"run C: exit {rc}, joint tags {at_c}; want exit 75 inside the polish leg after "
                             f"{want_c}:\n{log_c[-3000:]}")
    rc, log_d = run_cli(recipe_argv(store, "--resume"), root / "run_d.log")
    want_d = [f"[pipeline] stage '{s}' complete in store — skipping" for s in stages[:5]] + [
        f"[location_joint] resumed at step {at_c[0]}", "joint location evaluation"]
    missing = [w for w in want_d if w not in log_d]
    if rc != 0 or missing:
        raise AssertionError(f"run D: exit {rc}, missing {missing}:\n{log_d[-3000:]}")
    a, d = StageStore(str(runs["A"][0])), StageStore(str(store))
    for s in stages:
        assert_bitwise(d.load_stage(s), a.load_stage(s), f"run D's final {s} against run A's")
    phase(12, f"run B, the CLI with run A's flags: SIGTERM in the joint stage's bank leg, exit 75 {ms_b:.1f} ms after "
              f"the signal at step {at_b[0]}; run C, --resume: resumed at step {at_b[0]}, pinned the boundary at "
              f"{RECIPE_BANK}, SIGTERM in the polish leg, exit 75 {ms_c:.1f} ms after the signal at step {at_c[0]}; "
              f"run D, --resume: five stages skipped, resumed at step {at_c[0]}; every stage's final (weights, Adam, "
              f"step, all three generators) bitwise equal to run A's")
    shutil.rmtree(root)


def otf_phase(dev, counters, card: str) -> None:
    """Phase 12: on-the-fly training with run K's options at full width and geometry: the bank, the labels, the
    step times, and the recipe through the CLI with preemption and resume in each leg."""
    import torch
    from acoustic_locating_vq_vae_torch import data

    t_phase = time.perf_counter()
    cfg = OTF_CONFIG or data.DatasetConfig()
    bank = bank_phase(dev, cfg, card)
    label_phase(dev, cfg, bank)
    otf_timings(dev, cfg, bank, counters, card)
    del bank
    torch.cuda.empty_cache()
    recipe_phase(counters, card)
    phase(12, f"phase 12 took {time.perf_counter() - t_phase:.1f} s ({card})")



# ------------------------------------------------------------------ --converge: speech and RIR stages to a known loss


def converge_phase(dev, card: str) -> None:
    """Speech and RIR VQ-VAEs at full width, CONVERGE_UPDATES updates each in FP32 and in bf16 from the same seed,
    on a CONVERGE_ROWS set synthesized on the card (VALIDATION.md's stage-convergence run). Prints the recon of the
    first and last 100 updates, the perplexity of the last 100, the validation recon and the step time; fails
    where bf16's recon of the last 100 updates exceeds CONVERGE_BF16_LIMIT x FP32's. RNG streams differ from the
    JAX package's, so the readings are set beside its figures, not gated against them."""
    import torch
    from acoustic_locating_vq_vae_torch import data
    from acoustic_locating_vq_vae_torch.train import RirVQVAETask, SpeechVQVAETask, Trainer

    cfg = data.DatasetConfig()
    sets = {}
    for i, (name, n) in enumerate(CONVERGE_ROWS.items()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sets[name] = data.make_dataset(torch.Generator(dev).manual_seed(CONVERGE_SEED + i), n, cfg, device=dev)
        torch.cuda.synchronize()
        phase("converge", f"synthesized the {name} set, {n} rows, in {time.perf_counter() - t0:.2f} s")
    final = {}
    runs = [(label, cls, CONVERGE_SEED) for label, cls in (("speech", SpeechVQVAETask), ("rir", RirVQVAETask))]
    runs += [("rir", RirVQVAETask, seed) for seed in CONVERGE_SPREAD_SEEDS]
    for label, cls, seed in runs:
        for dtype in ("float32", "bfloat16"):
            tr = Trainer(cls(compute_dtype=dtype), device=dev, seed=seed, verbose=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = tr.fit(sets["train"], sets["val"], num_updates=CONVERGE_UPDATES).finalize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec, perp, val = hist["train"]["recon_error"], hist["train"]["perplexity"], hist["val"]["recon_error"]
            if not all(math.isfinite(float(v)) for v in (*rec, *val)):
                raise AssertionError(f"{label} {dtype}: a non-finite recon error")
            final[(label, seed, dtype)] = float(rec[-100:].mean())
            phase("converge", f"{label} VQ-VAE, {dtype}, seed {seed}, full width, {CONVERGE_UPDATES} updates on "
                              f"{CONVERGE_ROWS['train']} synthesized rows: recon first 100 {rec[:100].mean():.4f} -> last "
                              f"100 {rec[-100:].mean():.4f}, perplexity of the last 100 {perp[-100:].mean():.2f}, val recon "
                              f"{val.mean():.4f} (mean of {len(val)} eval steps on the {CONVERGE_ROWS['val']} val rows, "
                              f"last {val[-1]:.4f}); {wall:.1f} s, {wall / CONVERGE_UPDATES * 1e3:.2f} ms a step "
                              f"({card}); JAX on a TPU (VALIDATION.md:58-63, a yardstick of the loss only): speech "
                              f"0.49 -> 0.19, RIR 0.97 -> 0.124")
            del tr
            torch.cuda.empty_cache()
        ratio = final[(label, seed, "bfloat16")] / final[(label, seed, "float32")]
        gated = seed == CONVERGE_SEED
        phase("converge", f"{label}, seed {seed}: bf16's recon of the last 100 updates is {ratio:.4f}x FP32's"
                          + (f" (limit {CONVERGE_BF16_LIMIT})" if gated else " (the seed-to-seed spread, not gated)"))
    missed = [(label, final[(label, CONVERGE_SEED, "bfloat16")] / final[(label, CONVERGE_SEED, "float32")])
              for label in ("speech", "rir")]
    missed = [(label, r) for label, r in missed if r > CONVERGE_BF16_LIMIT]
    if missed:
        raise AssertionError(f"bf16 ends above {CONVERGE_BF16_LIMIT}x FP32's recon: {missed}")


# ------------------------------------------------------------------ phase 13: bf16 compute_dtype


# phase 13's stages: (label, stage, cached, task fields); the VQ-VAE stages in both codebook modes
BF16_STAGES = (("speech", "speech", False, {}), ("speech EMA", "speech", False, {"vq_ema": True}),
               ("rir", "rir", False, {}), ("rir EMA", "rir", False, {"vq_ema": True}),
               ("echoed", "echoed", False, {}), ("echoed cached", "echoed", True, {}), ("finetune", "finetune", False, {}),
               ("location", "location", False, {}), ("joint", "location_joint", False, {}))
BF16_SEED = 130
# The card's bf16 gradient of a step against the CPU port's bf16 step on the same weights, batch, jitter decisions
# and latents, ||card - CPU|| / ||CPU||, must stay within the CPU bf16 step's own distance from the same step in
# float64 (BF16_FRACTION of it): the bound comes from the CPU, never from the card. The CPU computes XLA-CPU's
# form (float32 sums of bf16-rounded operands); cuDNN's bf16 tensor-core kernels sum in another order and
# precision, and read 0.38 to 0.49 of the bound on the H100 (PERF.md). Where the CPU bf16 step lies within
# F32_REL of float64 (a float32 head behind the same codes), the card must lie within F32_REL of the CPU. That
# the card's convs ran in bf16 at all is checked by their outputs' dtype.
BF16_FRACTION = 1.0
F32_REL = 1e-5
# --converge: bf16's recon of the last 100 updates against FP32's, each stage, the same sets and updates (set
# before any run)
CONVERGE_BF16_LIMIT = 1.15
# --converge also trains the RIR stage (19 and 7 ms a step) from these seeds in both dtypes, not gated: the spread
# of the ratio from seed to seed
CONVERGE_SPREAD_SEEDS = (22, 23)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def vq_modules(tr) -> dict:
    """{name: VectorQuantizer} of a trainer's model and of its frozen RIR branch (``frozen.`` names)."""
    from acoustic_locating_vq_vae_torch.ops import VectorQuantizer

    mods = {n: m for n, m in tr.model.named_modules() if isinstance(m, VectorQuantizer)}
    if tr.frozen_rir is not None:
        mods.update({f"frozen.{n}": m for n, m in tr.frozen_rir.named_modules() if isinstance(m, VectorQuantizer)})
    return mods


@contextlib.contextmanager
def vq_inputs(mods: dict, feed: dict = None):
    """While open, records what each quantizer of ``mods`` reads ({name: tensor}, yielded); with ``feed``, each
    reads ``feed[name]`` straight through instead (``z + (feed - z).detach()``: the same codes, its own
    gradient path)."""
    seen, hooks = {}, []

    def hook(name):
        def pre(module, args):
            z = args[0]
            if feed is not None:
                z = z + (feed[name].to(z.device, z.dtype) - z).detach()
            seen[name] = z.detach()
            return (z,) + tuple(args[1:])
        return pre

    for name, m in mods.items():
        hooks.append(m.register_forward_pre_hook(hook(name)))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def bf16_codes_check(mods: dict, latents: dict, codebooks: dict, label: str) -> dict:
    """The card's VQ on the card's own float32 latent against the CPU's plain assignment of that same latent,
    under the tie rule; returns {name: card codes (CPU)}."""
    import torch
    from acoustic_locating_vq_vae_torch.ops.vq import assign, nearest_codebook

    codes = {}
    for name, z in latents.items():
        if z.dtype != torch.float32:
            raise AssertionError(f"{label}: quantizer {name} read {z.dtype}, want float32")
        flat = z.reshape(-1, mods[name].embedding_dim)
        got = assign(flat, codebooks[name])[0].cpu()
        want = nearest_codebook(flat.cpu(), codebooks[name].cpu())[0]
        check_codes(flat.cpu(), codebooks[name].cpu(), got, want, f"{label} {name} bf16 codes card vs CPU plain")
        codes[name] = got
    return codes


def bf16_stage_start(stage: str, kw: dict, composite, g, batch_size: int):
    """An FP32 CPU trainer of ``stage`` with phase 6's or phase 8's starting weights (codebooks of latent rows),
    and its seeded data: (trainer, data on the CPU)."""
    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.train import Trainer

    task = make_stage_task(stage, batch_size=batch_size, **kw)
    location = stage == "location"
    tr = Trainer(task, device="cpu", seed=BF16_SEED + 1, verbose=False, composite_params=composite if location else None)
    if stage in ("speech", "rir"):
        data = make_batch(2 * batch_size, g, "cpu")
        with full_fp32():
            latent_codebook_(tr.model, task.model_inputs(make_batch(8, g, "cpu"))[0], g)
    else:
        data = stage_batch(2 * batch_size, g, "cpu")
        start_stage(tr, composite, g)
    return tr, data


def bf16_step_card_vs_cpu(label: str, stage: str, cached: bool, kw: dict, composite, dev, counters):
    """Phase 13 (a): one bf16 train step of a stage at CHECK_B on the card, from the FP32 step's weights, against
    the CPU port's bf16 step and the same step in float64 on the CPU, both fed the card's latents (the same
    codes). Checks: the kernels' launches, a finite float32 loss, float32 parameters and Adam state, the card's
    codes on its own latent against the CPU plain assignment (tie rule), every gradient within BF16_FRACTION of
    the CPU bf16 step's distance from float64. Returns (worst ratio, its parameter), the CPU bf16 and the card's
    worst distance from float64, the code agreement with the FP32 step, and the launches."""
    import dataclasses
    import gc

    import torch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.ops.vq import assign
    from acoustic_locating_vq_vae_torch.train import Trainer

    g = torch.Generator().manual_seed(BF16_SEED)
    cpu32, data = bf16_stage_start(stage, kw, composite, g, CHECK_B)
    task16 = dataclasses.replace(cpu32.task, compute_dtype="bfloat16")
    location = stage == "location"
    comp = composite if location else None
    card = Trainer(task16, device=dev, seed=BF16_SEED + 1, verbose=False, composite_params=comp)
    cpu16 = Trainer(task16, device="cpu", seed=BF16_SEED + 1, verbose=False, composite_params=comp)
    for tr in (card, cpu16):
        tr.model.load_state_dict(cpu32.model.state_dict())
    ref = copy.copy(cpu32)  # the float64 reference: the same step in exact arithmetic
    ref.model = copy.deepcopy(cpu32.model).double()
    ref.frozen_rir = copy.deepcopy(cpu32.frozen_rir).double() if location else None
    ref.jitter_generator = torch.Generator()
    ref.jitter_generator.set_state(cpu32.jitter_generator.get_state())
    card32 = copy.copy(cpu32)  # the FP32 step's codes on the card, for the agreement
    card32.model = copy.deepcopy(cpu32.model).to(dev)
    card32.frozen_rir = copy.deepcopy(cpu32.frozen_rir).to(dev) if location else None

    resident = card.to_device(data)
    cache = card.build_cache(resident) if cached else None
    batch, rows = card.sample_cached(resident, cache) if cached else (card.sample(resident), None)
    mods = vq_modules(card)
    codebooks = {n: m._embedding.weight.detach().clone() for n, m in mods.items()}
    if cached:  # the step reads codes: the card's latents of its cache rows, from the uncached eval loss
        with torch.no_grad(), vq_inputs(mods) as latents:
            card._loss(batch, False, None)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with count_by_shape(), vq_inputs(mods) as seen, conv_calls(card) as convs:
        metrics = card.step(batch, cache=rows)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    dtypes = {dt for dt, _ in convs}
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"{label}: the card's bf16 step ran convolutions with outputs of {dtypes}")
    if not cached:
        latents = seen
    codes = bf16_codes_check(mods, latents, codebooks, label)
    if cached:
        for k, v in rows.items():
            name = "rir_model._vq" if k == "rir_codes" else "speech_model._vq"
            if not torch.equal(v.flatten().long().cpu(), codes[name].long()):
                raise AssertionError(f"{label}: the cache's {k} differ from the card's codes of the same rows")
    if not math.isfinite(float(metrics["loss"])) or metrics["loss"].dtype != torch.float32:
        raise AssertionError(f"{label}: bf16 loss {metrics['loss']}")
    state_dtypes = [p.dtype for p in card.model.parameters()]
    state_dtypes += [t.dtype for st in card.optimizer.state.values() for t in st.values() if t.is_floating_point()]
    if any(dt != torch.float32 for dt in state_dtypes):
        raise AssertionError(f"{label}: a parameter or Adam state is not float32")
    g_card = {k: p.grad.detach().cpu() for k, p in card.model.named_parameters() if p.grad is not None}

    batch_cpu = batch.map(lambda a: a.cpu())
    rows_cpu = None if rows is None else {k: v.cpu() for k, v in rows.items()}
    with vq_inputs(vq_modules(cpu16), latents):
        cpu16.step(batch_cpu, cache=rows_cpu)
    g_cpu = {k: p.grad.detach() for k, p in cpu16.model.named_parameters() if p.grad is not None}
    batch64 = batch_cpu.map(lambda a: a.double() if a.is_floating_point() else a)
    with vq_inputs(vq_modules(ref), latents):
        ref._loss(batch64, True, rows_cpu)[0].backward()
    g64 = {k: p.grad.detach() for k, p in ref.model.named_parameters() if p.grad is not None}
    if not set(g_card) == set(g_cpu) == set(g64):
        raise AssertionError(f"{label}: parameters with a gradient differ between the card, the CPU and float64")
    worst, far, far_card = (0.0, ""), 0.0, 0.0
    for k, r in g64.items():
        d_card, d_cpu = rel_l2(g_card[k], g_cpu[k]), rel_l2(g_cpu[k], r)
        far, far_card = max(far, d_cpu), max(far_card, rel_l2(g_card[k], r))
        limit = F32_REL if d_cpu <= F32_REL else BF16_FRACTION * d_cpu
        if d_card > limit:
            raise AssertionError(f"{label}: the card's bf16 gradient of {k} lies {d_card:.3g} from the CPU's, whose "
                                 f"distance from float64 {d_cpu:.3g} allows {limit:.3g}")
        worst = max(worst, (d_card / d_cpu if d_cpu > F32_REL else 0.0, k))
    with torch.no_grad(), full_fp32(), vq_inputs(vq_modules(card32)) as lat32:
        card32._loss(batch, False, None)
    agree = []
    for name, z in lat32.items():
        c32 = assign(z.reshape(-1, mods[name].embedding_dim), codebooks[name])[0].cpu()
        agree.append(float((c32 == codes[name]).float().mean()))
    del cpu32, cpu16, card, ref, card32
    gc.collect()
    torch.cuda.empty_cache()
    return worst, far, far_card, min(agree), launches


@contextlib.contextmanager
def unpinned():
    """cuDNN free to pick non-deterministic algorithms inside ``Trainer.step`` (a yardstick of the pin, not a
    switch of the program)."""
    import torch
    from acoustic_locating_vq_vae_torch.train import loop

    saved, cudnn = loop.deterministic_convs, torch.backends.cudnn
    loop.deterministic_convs, flag = contextlib.nullcontext, cudnn.deterministic
    cudnn.deterministic = False
    try:
        yield
    finally:
        loop.deterministic_convs, cudnn.deterministic = saved, flag


@contextlib.contextmanager
def conv_calls(tr):
    """While open, records every convolution the trainer's modules run (yields a list of (output dtype, FLOPs)):
    2 x B x L x C_in x C_out x k forward, three times that for a layer whose weight gets a gradient (the input
    gradient and the weight gradient)."""
    import torch
    from acoustic_locating_vq_vae_torch.ops import Conv1d, ConvTranspose1d

    calls, hooks = [], []

    def record(module, args, out):
        w = module.weight
        fwd = 2.0 * out.shape[0] * out.shape[2] * w.shape[0] * w.shape[1] * w.shape[2]
        calls.append((out.dtype, fwd * (3 if torch.is_grad_enabled() and w.requires_grad else 1)))

    for root in (tr.model, tr.frozen_rir):
        for m in (root.modules() if root is not None else ()):
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                hooks.append(m.register_forward_hook(record))
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


# kernel classes by name, the first that matches wins
KERNEL_CLASSES = (("VQ kernels", ("vq_nearest", "vq_codebook")),
                  ("NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose")),
                  ("casts and copies", ("copy", "convert")),
                  ("convolution (cuDNN)", ("xmma", "implicit_gemm", "cudnn", "conv", "cutlass", "sm90_", "sm80_", "gemm")),
                  ("Adam", ("multi_tensor_apply",)),
                  ("elementwise and reductions", ("elementwise", "reduce")))


def kernel_shares(top, busy_us: float) -> dict:
    """Device time by class of kernel name (KERNEL_CLASSES, else "other"), as shares of ``busy_us``."""
    shares = collections.Counter()
    for name, _, us in top:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        shares[cls] += us
    return {k: v / busy_us for k, v in shares.items()}


def bf16_timings(composite, dev, counters, card: str) -> dict:
    """Phase 13 (b): every stage's train step at its own batch size, FP32 and bf16, each with and without the
    deterministic pin (medians of 10 after 3 warm-ups); the bf16 step's launches, loss, parameters and codes (tie
    rule) at that batch size; the TF32 speech yardstick; profiles of the speech and echoed bf16 steps. Returns
    {label: {(dtype, pinned): ms}}."""
    import dataclasses
    import gc

    import torch
    from acoustic_locating_vq_vae_torch.train import Trainer

    times = {}
    for label, stage, cached, kw in BF16_STAGES:
        g = torch.Generator().manual_seed(BF16_SEED)
        b = make_stage_task(stage).batch_size
        cpu32, data = bf16_stage_start(stage, kw, composite, g, b)
        state = cpu32.model.state_dict()
        row = {}
        for dtype in ("float32", "bfloat16"):
            task = dataclasses.replace(cpu32.task, compute_dtype=dtype)
            tr = Trainer(task, device=dev, seed=BF16_SEED + 1, verbose=False,
                         composite_params=composite if stage == "location" else None)
            tr.model.load_state_dict(state)
            resident = tr.to_device(data)
            cache = tr.build_cache(resident) if cached else None
            for c in counters:
                c.launches = 0
            with count_by_shape():
                row[(dtype, True)] = step_times_ms(tr, resident, cache)[0]
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
            with unpinned():
                row[(dtype, False)] = step_times_ms(tr, resident, cache)[0]
            if dtype == "bfloat16":
                need = [] if cached else ["nearest_indices_cuda"]
                if stage in ("speech", "rir"):
                    need.append("codebook_stats_cuda" if kw.get("vq_ema") else "codebook_grad_cuda")
                if any(launches[n] < 1 for n in need) or (cached and launches["nearest_indices_cuda"]):
                    raise AssertionError(f"{label} bf16 timed run launched {launches}")
                mods = vq_modules(tr)
                codebooks = {n: m._embedding.weight.detach().clone() for n, m in mods.items()}
                if cached:
                    batch, rows = tr.sample_cached(resident, cache)
                    with torch.no_grad(), vq_inputs(mods) as lat:
                        tr._loss(batch, False, None)
                    metrics = tr.step(batch, cache=rows)
                else:
                    with vq_inputs(mods) as lat:
                        metrics = one_step(tr, resident)
                bf16_codes_check(mods, dict(lat), codebooks, f"{label} B={b}")
                if not math.isfinite(float(metrics["loss"])) or any(p.dtype != torch.float32 for p in tr.model.parameters()):
                    raise AssertionError(f"{label} B={b}: bf16 loss {metrics['loss']} or a non-float32 parameter")
                row["launches"] = launches
                if label in ("speech", "echoed"):
                    row["profile"] = bf16_profile(tr, resident, cache)
            elif label == "speech":
                row["tf32"] = yardstick_step_ms(tr, resident, tf32=True, deterministic=True)
            del tr, resident, cache
            gc.collect()
            torch.cuda.empty_cache()
        times[label] = row
        f32, bf = row[("float32", True)], row[("bfloat16", True)]
        phase(13, f"(b) {label} train step at B={b}, full width, median of 10: FP32 {f32:.4f} ms, bf16 {bf:.4f} ms "
                  f"({f32 / bf:.2f}x); without the deterministic pin FP32 {row[('float32', False)]:.4f}, bf16 "
                  f"{row[('bfloat16', False)]:.4f} ms; bf16 launches over its 13 pinned steps {row['launches']}; "
                  f"bf16 step at B={b}: finite float32 loss, float32 parameters, codes under the tie rule"
                  + (f"; TF32 yardstick {row['tf32']:.4f} ms" if "tf32" in row else "") + f" ({card})")
    return times


def bf16_profile(tr, resident, cache) -> str:
    """A 3-step torch.profiler breakdown of a bf16 step: top kernels, the shares by class (the convolutions,
    the NCHW<->NHWC transposes, casts, elementwise kernels, the VQ kernels) and the convolutions' TFLOP/s."""
    with conv_calls(tr) as convs:
        one_step(tr, resident, cache)
    flops = sum(f for _, f in convs)
    wall_us, busy_us, top = device_breakdown(lambda d: one_step(tr, d, cache), [resident] * 3, top=10_000)
    if busy_us == 0:
        return "the profiler recorded no device time"
    shares = kernel_shares(top, busy_us)
    conv_s = shares.get("convolution (cuDNN)", 0.0) * busy_us / 3 / 1e6
    tops = "; ".join(f"{k[:60]} x{c} {t / 3 / 1e3:.3f} ms ({t / busy_us:.1%})" for k, c, t in top[:6])
    return (f"per step {wall_us / 3 / 1e3:.4f} ms host clock, card busy {busy_us / 3 / 1e3:.4f} ms "
            f"({busy_us / wall_us:.1%}); by class: "
            + ", ".join(f"{k} {v:.2%}" for k, v in sorted(shares.items(), key=lambda kv: -kv[1]))
            + f"; convolutions {flops / 1e12:.3f} TFLOP a step"
            + (f" at {flops / conv_s / 1e12:.1f} TFLOP/s" if conv_s else "") + f"; top kernels: {tops}")


def bf16_serving(dev, cfg, paths, specs, counters, card: str) -> None:
    """Phase 13 (c): the joint and frozen localizers of phase 3's weights built from bf16 tasks serve B = 8 and
    64 on the card: the kernel's launches, latency beside FP32 serving of the same weights, and the largest
    |delta theta| (wrap-aware) against FP32 serving on the same inputs."""
    import dataclasses

    import torch
    from acoustic_locating_vq_vae_torch.eval import make_serving_fn

    for name, (task, params, comp, _) in paths.items():
        serve = {dt: make_serving_fn(dataclasses.replace(task, compute_dtype=dt), params, cfg, comp, device=dev)
                 for dt in ("float32", "bfloat16")}
        parts = []
        for b in (8, SERVE_B):
            inputs = [s.to(dev) for s in specs(b, 20)]
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            with count_by_shape():
                outs = {dt: [f(x) for x in inputs[:4]] for dt, f in serve.items()}
            torch.cuda.synchronize()
            if counters[0].launches < 8:
                raise AssertionError(f"{name} serving launched vq_nearest {counters[0].launches} times for 8 calls")
            dth = max(float((torch.remainder(a[0] - f[0] + math.pi, 2 * math.pi) - math.pi).abs().max())
                      for a, f in zip(outs["bfloat16"], outs["float32"]))
            for theta, radius, coords in outs["bfloat16"]:
                if not all(bool(torch.isfinite(t).all()) for t in (theta, radius, coords)):
                    raise AssertionError(f"{name} bf16 serving returned a non-finite value")
            lat = {dt: serve_latency_ms(f, inputs) for dt, f in serve.items()}
            parts.append(f"B={b} bf16 {lat['bfloat16']:.4f} ms, FP32 {lat['float32']:.4f} ms, largest |dtheta| "
                         f"against FP32 {dth:.4g} rad")
            del inputs, outs
        phase(13, f"(c) {name} localizer served from a bf16 task (head and VQ in FP32), median of 20: "
                  + "; ".join(parts) + f" ({card})")


def bf16_phase(dev, counters, card: str, composite, paths, cfg, specs) -> None:
    """Phase 13: bf16 compute_dtype: (a) a bf16 step per stage card vs CPU, (b) step times beside FP32 and
    profiles, (c) serving, (d) the pipeline in bf16 with preemption and resume."""
    t_phase = time.perf_counter()
    rows = []
    for label, stage, cached, kw in BF16_STAGES:
        worst, far, far_card, agree, launches = bf16_step_card_vs_cpu(label, stage, cached, kw, composite, dev, counters)
        need = [] if cached else ["nearest_indices_cuda"]
        if stage in ("speech", "rir"):
            need.append("codebook_stats_cuda" if kw else "codebook_grad_cuda")
        if any(launches[n] < 1 for n in need):
            raise AssertionError(f"{label} bf16 step launched {launches}")
        rows.append(f"{label} {worst[0]:.3g} ({worst[1]}), float64 CPU {far:.3g} card {far_card:.3g}, "
                    f"codes {agree:.4f}, launches {launches}")
    phase(13, f"(a) one bf16 step per stage at full width, B={CHECK_B}, card vs the CPU port's bf16 step on the same "
              f"weights, batch and latents: every convolution's output bf16, every gradient within {BF16_FRACTION} "
              f"of the CPU step's distance from float64 (||.|| / ||.||); per stage the worst ratio, the CPU's and the card's worst distance from "
              f"float64, the share of codes equal to the FP32 step's, the launches: " + "; ".join(rows)
              + f"; phase 13 (a) took {time.perf_counter() - t_phase:.1f} s")
    times = bf16_timings(composite, dev, counters, card)
    for label in ("speech", "echoed"):
        phase(13, f"(b) {label} bf16 step profiled: {times[label]['profile']} ({card})")
    bf16_serving(dev, cfg, paths, specs, counters, card)
    pipeline_phase(dev, counters, card, compute_dtype="bfloat16", ph=13)
    phase(13, f"phase 13 took {time.perf_counter() - t_phase:.1f} s ({card})")


def flat_latent(rir, spec):
    """The pre-VQ latent rows the quantizer of ``rir`` sees for echoed spectrograms ``spec``."""
    from acoustic_locating_vq_vae_torch.dsp import znorm

    z = rir.pre_vq_latent(znorm(spec, dim=1).transpose(1, 2))
    return (z if rir.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, rir.embedding_dim)


def wrapped_max(got, want) -> float:
    """Largest |got - want| over (theta, radius, coords), theta on the circle."""
    import torch

    dth = torch.remainder(got[0].float() - want[0].float() + math.pi, 2 * math.pi) - math.pi
    return max(float(dth.abs().max()), *(float((a.float() - b.float()).abs().max()) for a, b in zip(got[1:], want[1:])))


def deploy_store(root: Path, cfg, g) -> dict:
    """Phase 14's stage store at DEPLOY_WIDTH, written as the pipeline writes one (``StageStore.save_stage``
    with the metadata ``Trainer`` writes): seeded weights, each codebook made of pre-VQ latent rows of a
    separate seeded batch: location_joint (sincos + radius, vectors flatten: the run K artifact's model),
    location (one-hot encodings, theta/pi: the 843 MB fc_1 at full width) over finetune (the composite,
    memory-order flatten) and speech (for resynthesize). Phase 10 deletes its store, so this phase writes its
    own. Returns ``{"joint" | "frozen": (task, params, RIR-branch params or None, RIR branch module)}``."""
    import torch
    from acoustic_locating_vq_vae_torch.cli.common import rir_branch
    from acoustic_locating_vq_vae_torch.eval import full_fp32
    from acoustic_locating_vq_vae_torch.train import (
        EchoedSpeechTask, JointLocationTask, LocationTask, SpeechVQVAETask, checkpoint_metadata,
    )
    from acoustic_locating_vq_vae_torch.utils import StageStore

    kw = dict(config=cfg, width_scale=DEPLOY_WIDTH)
    joint_task, location_task, echoed_task, speech_task = (
        JointLocationTask(**kw, predict_radius=True), LocationTask(**kw), EchoedSpeechTask(**kw), SpeechVQVAETask(**kw))
    joint = joint_task.build_model(g)
    with full_fp32():
        spec = torch.empty(8, cfg.num_freq, cfg.num_frames).exponential_(generator=g)
        latent_codebook_(joint.rir_model, joint_task.model_inputs(spec)[0], g)
    composite = composite_weights(echoed_task, g)
    branch = rir_branch(composite)
    rir = location_task.build_rir_model()
    rir.load_state_dict(branch)
    head = location_task.build_model(g).state_dict()
    store = StageStore(str(root))
    for tag, task, weights in (("speech", speech_task, speech_task.build_model(g).state_dict()),
                               ("finetune", echoed_task, composite), ("location", location_task, head),
                               ("location_joint", joint_task, joint.state_dict())):
        store.save_stage(tag, {"model": weights}, step=0, metadata=dict(checkpoint_metadata(task, True), task=tag))
    return {"joint": (joint_task, joint.state_dict(), None, joint.rir_model),
            "frozen": (location_task, head, branch, rir)}


def run_deploy_clis(jobs: dict, root: Path) -> dict:
    """Start every ``name: (cli module, argv)`` of ``jobs`` at once as ``python -m
    acoustic_locating_vq_vae_torch.cli.<module> argv --device DEVICE --width-scale DEPLOY_WIDTH``, wait for
    all, and stop any still running; returns ``{name: (exit code, stdout, stderr)}``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONIOENCODING="utf-8")
    procs = {}
    try:
        for name, (module, argv) in jobs.items():
            cmd = [sys.executable, "-u", "-m", f"{PKG}.cli.{module}", *argv, "--device", DEVICE,
                   "--width-scale", str(DEPLOY_WIDTH)]
            out, err = open(root / f"{name}.out", "w"), open(root / f"{name}.err", "w")
            procs[name] = (subprocess.Popen(cmd, stdout=out, stderr=err, env=env, cwd=REPO), out, err)
        results = {}
        for name, (proc, out, err) in procs.items():
            rc = proc.wait(timeout=900)
            out.close()
            err.close()
            results[name] = (rc, (root / f"{name}.out").read_text(encoding="utf-8"),
                             (root / f"{name}.err").read_text(encoding="utf-8"))
        return results
    finally:
        for proc, out, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def last_json(text: str):
    """The JSON object a CLI printed last (one line, or indented over several)."""
    lines = text.splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return json.loads("\n".join(lines[start:]))


# Phase 14 (b): a fresh process that loads artifacts cold. It imports torch and the one module of the port an
# artifact needs, ops.vq (it registers the VQ operator the graph calls), and nothing else of the port; it sets
# TF32 off as load_localizer's call does (full_fp32), and for the control leaves cuDNN's TF32 at PyTorch's
# default, on. argv: the port's source root, the jobs file, the device.
COLD_LOAD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import acoustic_locating_vq_vae_torch.ops.vq
from acoustic_locating_vq_vae_torch.ops.vq_cuda import nearest_indices_cuda

device = torch.device(sys.argv[3])
cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul


def run(module, x, tf32):
    cudnn.allow_tf32, matmul.allow_tf32 = tf32, False
    before = nearest_indices_cuda.launches
    with torch.inference_mode():
        out = module(x.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return [t.cpu() for t in out], nearest_indices_cuda.launches - before


report = {}
for job in json.load(open(sys.argv[2])):
    module = torch.export.load(job["artifact"]).module()
    targets = [str(n.target) for n in module.graph.nodes if n.op == "call_function"]
    outs, launches = [], []
    for x in torch.load(job["inputs"]):
        out, n = run(module, x, False)
        outs.append(out)
        launches.append(n)
    control = run(module, x, True)[0] if job["control"] else None
    torch.save({"outs": outs, "control": control}, job["out"])
    report[job["name"]] = {"op": targets.count(job["op"]), "argmin": sum("argmin" in t for t in targets),
                           "launches": launches}
report["modules"] = sorted(m for m in sys.modules if m.startswith("acoustic_locating_vq_vae_torch"))
print(json.dumps(report))
"""


def deploy_phase(dev, counters, card: str) -> None:
    """Phase 14, the deploy surface at full width: (a) the export CLI writes the joint (symbolic batch, with
    its --latency bench), the frozen and the joint --from-audio artifacts, three processes at once; (b) a fresh
    process loads each cold with torch and ops.vq alone and runs B = 1, 8, 64 (waveforms: 1, 8): each equals
    the live closure within ATOL, each graph holds the operator once and no argmin, each call launches
    vq_nearest once; (c) at B = 8 the card's artifact against the CPU port on the same weights, codes under
    the tie rule; (d) a control run of each loaded program under cuDNN's default TF32, its largest |dtheta|
    (not gated); (e) the --from-audio artifact on 80,000-sample waveforms; (f) a bf16 joint artifact against
    its live closure; (g) serve latency, median of 20, artifact and live closure in turns (live, artifact,
    artifact, live) at B = 8 and 64; (h) locate, track (arc, 24 windows), eval_t60_sweep (two T60s, n = 8),
    compare_location_models and resynthesize with --device, five processes at once: exit 0, JAX's JSON keys
    (resynthesize prints lines and no JSON, as JAX's script does: its two wav files are checked)."""
    import dataclasses

    import torch
    from acoustic_locating_vq_vae_torch.data import DatasetConfig
    from acoustic_locating_vq_vae_torch.dsp import znorm
    from acoustic_locating_vq_vae_torch.eval import export_localizer, full_fp32, load_localizer, make_serving_fn

    t_phase = time.perf_counter()
    root = DEPLOY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = DatasetConfig()
    g = torch.Generator().manual_seed(DEPLOY_SEED)
    t0 = time.perf_counter()
    paths = deploy_store(root / "store", cfg, g)
    store = str(root / "store")
    phase(14, f"store of seeded weights at width {DEPLOY_WIDTH} written in {time.perf_counter() - t0:.2f} s "
              f"({sum(f.stat().st_size for f in (root / 'store').rglob('*.pt'))} bytes): speech, finetune, "
              "location (one-hot encodings), location_joint (sincos + radius)")

    # ---- (a) the export CLI, three artifacts at once
    arts = {"joint": root / "joint", "frozen": root / "frozen", "audio": root / "joint_audio"}
    export = lambda name, *extra: ("export_localizer", ["--store-dir", store, "--out-dir", str(arts[name]),
                                                        "--verify-n", "8", *extra])
    runs = run_deploy_clis({"joint": export("joint", "--model", "joint", "--latency", "10"),
                            "frozen": export("frozen", "--model", "frozen"),
                            "audio": export("audio", "--model", "joint", "--from-audio")}, root)
    exported = {}
    for name, (rc, out, err) in runs.items():
        if rc != 0:
            raise AssertionError(f"(a) export_localizer {name} exited {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        m = re.search(r"\((\d+) bytes, platforms \['(\w+)'\]\) in ([0-9.]+) s", out)
        summary = last_json(out)
        keys = {"verified", "max_abs_diff", "theta_pred_rad"} | ({"artifact_latency"} if name == "joint" else set())
        if m is None or m.group(2) != dev.type or not summary["verified"] or set(summary) != keys:
            raise AssertionError(f"(a) export_localizer {name}: {out[-2000:]}")
        exported[name] = (int(m.group(1)), float(m.group(3)), summary)
    lat = exported["joint"][2]["artifact_latency"]
    phase(14, "(a) export_localizer CLI, verified against the live model on the card (max |diff| < "
              f"{ATOL}): " + "; ".join(f"{n} {b} bytes, exported in {t:.3f} s, max |diff| {max(s['max_abs_diff'].values()):.3g}"
                                        for n, (b, t, s) in exported.items())
              + f"; the CLI's --latency on the joint artifact, B=8: p50 {lat['p50_ms']} ms, mean {lat['mean_ms']} ms "
              f"({lat['device']}; {card})")

    # ---- (b) to (e): cold loads in a fresh process, against the live closures
    specs = {b: torch.empty(b, cfg.num_freq, cfg.num_frames).exponential_(generator=g) for b in DEPLOY_BATCHES}
    waves = {b: torch.randn(b, cfg.audio_samples, generator=g) for b in (1, 8)}
    torch.save([specs[b] for b in DEPLOY_BATCHES], root / "specs.pt")
    torch.save(list(waves.values()), root / "waves.pt")
    jobs = [{"name": n, "artifact": str(arts[n] / "localizer.pt2"), "op": OP_TARGET, "control": n != "audio",
             "inputs": str(root / ("waves.pt" if n == "audio" else "specs.pt")), "out": str(root / f"{n}_out.pt")}
            for n in arts]
    (root / "jobs.json").write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", COLD_LOAD, str(REPO / "src"), str(root / "jobs.json"), DEVICE],
                           capture_output=True, text=True, timeout=900, cwd=root)
    cold_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"(b) the cold-load process exited {child.returncode}:\n{child.stderr[-3000:]}")
    report = last_json(child.stdout)
    extra = [m for m in report["modules"] if m not in (PKG, f"{PKG}.ops") and not m.startswith(f"{PKG}.ops.")]
    if extra:
        raise AssertionError(f"(b) loading the artifacts imported more of the port than the operator: {extra}")
    loaded = {n: torch.load(root / f"{n}_out.pt") for n in arts}
    for name, r in report.items():
        if name != "modules" and (r["op"] != 1 or r["argmin"] or any(n != 1 for n in r["launches"])):
            raise AssertionError(f"(b) {name}: graph holds the operator {r['op']} times, argmin {r['argmin']} "
                                 f"times; vq_nearest launches per call {r['launches']}")
    for name in ("joint", "frozen"):
        task, params, branch, rir = paths[name]
        serve = make_serving_fn(task, params, cfg, branch, device=dev)
        errs = [wrapped_max(out, [t.cpu() for t in serve(specs[b].to(dev))])
                for b, out in zip(DEPLOY_BATCHES, loaded[name]["outs"])]
        if max(errs) > ATOL:
            raise AssertionError(f"(b) {name}: artifact against the live closure {errs} at B={DEPLOY_BATCHES}")
        # (c) the card's artifact against the CPU port at B = 8, codes under the tie rule
        art8 = loaded[name]["outs"][DEPLOY_BATCHES.index(8)]
        cpu = make_serving_fn(task, params, cfg, branch, device="cpu")(specs[8])
        with torch.inference_mode(), full_fp32():
            x = znorm(specs[8], dim=1).transpose(1, 2)
            codes_cpu = rir.get_latent_codes(x)
            rir_card = copy.deepcopy(rir).to(dev)
            codes_card = rir_card.get_latent_codes(x.to(dev)).cpu()
            mism, gap = check_codes(flat_latent(rir, specs[8]), rir._vq._embedding.weight, codes_card.flatten(),
                                    codes_cpu.flatten(), f"(c) {name} codes card vs CPU")
            del rir_card
        same = (codes_cpu == codes_card).all(1)
        c_err = wrapped_max([t[same] for t in art8], [t[same] for t in cpu]) if bool(same.any()) else float("nan")
        if int(same.sum()) < 1 or c_err > ATOL:
            raise AssertionError(f"(c) {name}: artifact on the card vs the CPU port {c_err} over {int(same.sum())} samples")
        # (d) the same program under cuDNN's default TF32, not gated
        ctrl = wrapped_max(loaded[name]["control"], loaded[name]["outs"][-1])
        phase(14, f"(b) {name} artifact loaded cold (torch and {PKG}.ops alone; load and runs {cold_s:.2f} s for all "
                  f"three): operator once, no argmin, vq_nearest once per call, max |artifact - live| {max(errs):.3g} "
                  f"at B={DEPLOY_BATCHES}; (c) card vs CPU port at B=8: codes differ on {mism} tie rows (gap {gap}), "
                  f"{int(same.sum())}/8 samples with equal codes, max |diff| {c_err:.3g}; (d) TF32 control at "
                  f"B={SERVE_B}: max |diff| (theta on the circle) {ctrl:.4g} against the FP32 artifact (not gated)")

    task, params, _, _ = paths["joint"]
    serve_audio = make_serving_fn(task, params, cfg, device=dev, from_audio=True)
    a_errs = [wrapped_max(out, [t.cpu() for t in serve_audio(waves[b].to(dev))])
              for b, out in zip(waves, loaded["audio"]["outs"])]
    if max(a_errs) > ATOL:
        raise AssertionError(f"(e) from_audio artifact against the live closure: {a_errs}")
    phase(14, f"(e) the --from-audio joint artifact on {cfg.audio_samples}-sample waveforms at B={tuple(waves)}: "
              f"max |artifact - live| {max(a_errs):.3g}, vq_nearest once per call")

    # ---- (f) a bf16 joint artifact against its live closure
    bf_task = dataclasses.replace(task, compute_dtype="bfloat16")
    serve_bf = make_serving_fn(bf_task, params, cfg, device=dev)
    t0 = time.perf_counter()
    meta_bf = export_localizer(bf_task, params, cfg, str(root / "joint_bf16"), serve_fn=serve_bf)
    bf_s = time.perf_counter() - t0
    call_bf, _ = load_localizer(str(root / "joint_bf16"))
    bf_errs = []
    for b in (8, SERVE_B):
        x = specs[b].to(dev)
        before = counters[0].launches
        got = call_bf(x)
        if counters[0].launches != before + 1:
            raise AssertionError("(f) the bf16 artifact's call did not launch vq_nearest once")
        bf_errs.append(wrapped_max(got, serve_bf(x)))
    targets = [str(n.target) for n in call_bf.module.graph.nodes if n.op == "call_function"]
    if max(bf_errs) > ATOL or targets.count(OP_TARGET) != 1:
        raise AssertionError(f"(f) bf16 artifact against its live closure {bf_errs}, operator {targets.count(OP_TARGET)} times")
    phase(14, f"(f) bf16 joint artifact ({meta_bf['bytes']} bytes, exported in {bf_s:.3f} s in process): max "
              f"|artifact - live| {max(bf_errs):.3g} at B=8, {SERVE_B}")
    del call_bf, serve_bf

    # ---- (g) serve latency, artifact and live closure in turns
    lines = []
    for c in counters:
        c.launches = 0
    calls = 0
    with count_by_shape():
        for name in ("joint", "frozen"):
            t_, p_, branch, _ = paths[name]
            live = make_serving_fn(t_, p_, cfg, branch, device=dev)
            art, _ = load_localizer(str(arts[name]))
            parts = []
            for b in (8, SERVE_B):
                inputs = [torch.empty(b, cfg.num_freq, cfg.num_frames).exponential_(generator=g).to(dev)
                          for _ in range(20)]
                l1, a1, a2, l2 = (serve_latency_ms(f, inputs) for f in (live, art, art, live))
                calls += 4 * (len(inputs) + 3)  # serve_latency_ms warms up on three of them
                parts.append(f"B={b} artifact {a1:.4f} / {a2:.4f} ms, live {l1:.4f} / {l2:.4f} ms")
            lines.append(f"{name}: " + "; ".join(parts))
            del live, art
    torch.cuda.synchronize()
    if counters[0].launches != calls:
        raise AssertionError(f"(g) {calls} serve calls launched vq_nearest {counters[0].launches} times")
    phase(14, "(g) serve latency, median of 20 distinct inputs after 3 warm-ups, in turns: " + " | ".join(lines)
              + f"; vq_nearest launches {counters[0].launches} for {calls} calls ({card})")

    # ---- (h) the deploy and evaluation CLIs, five processes at once
    data = ["--dataset-size", "8", "--val-size", "8"]
    runs = run_deploy_clis({
        "locate": ("locate", ["--store-dir", store, "--n", "8", "--latency", "5", *data]),
        "track": ("track", ["--store-dir", store, "--windows", "24", "--out", str(root / "track.npz")]),
        "eval_t60_sweep": ("eval_t60_sweep", ["--store-dir", store, "--t60-grid", "0.3", "0.6", "--n", "8"]),
        "compare_location_models": ("compare_location_models", ["--store-dir", store, *data]),
        "resynthesize": ("resynthesize", ["--store-dir", store, "--dataset-size", "2", "--val-size", "0",
                                          "--gl-iters", "8", "--out-prefix", str(root / "resynth")]),
    }, root)
    lines = []
    for name, (rc, out, err) in runs.items():
        if rc != 0:
            raise AssertionError(f"(h) {name} exited {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        if name == "resynthesize":
            wavs = [root / f"resynth_{k}.wav" for k in ("original", "recon")]
            if not all(w.exists() and w.stat().st_size > 44 for w in wavs) or "spectral SNR" not in out:
                raise AssertionError(f"(h) resynthesize wrote {[w.name for w in wavs if w.exists()]}:\n{out[-2000:]}")
            lines.append(f"resynthesize: {out.strip().splitlines()[-1]}")
            continue
        got = last_json(out)
        if set(got) != DEPLOY_CLI_KEYS[name]:
            raise AssertionError(f"(h) {name} printed keys {sorted(got)}, want {sorted(DEPLOY_CLI_KEYS[name])}")
        if name == "locate":
            lines.append(f"locate: rmse {got['rmse_radians']} rad, latency p50 {got['latency']['p50_ms']} ms at B=8 "
                          f"({got['latency']['device']})")
        elif name == "track":
            lines.append(f"track: rmse {got['rmse_radians']}, smoothed {got['rmse_smoothed_radians']} rad")
        elif name == "eval_t60_sweep":
            lines.append(f"eval_t60_sweep: rmse {got['rmse_radians_min']:.4f}-{got['rmse_radians_max']:.4f} rad")
        else:
            rmse = ", ".join(f"{k} {v['rmse_radians']:.4f}" for k, v in got.items())
            lines.append(f"compare_location_models: rmse {rmse} rad")
    phase(14, "(h) the CLIs on the card with random weights, exit 0, JAX's keys: " + "; ".join(lines))
    shutil.rmtree(root)
    phase(14, f"phase 14 took {time.perf_counter() - t_phase:.1f} s ({card})")


def manifest_task(stage: str, cfg, compute_dtype: str = "float32"):
    """The task of ``stage`` as phase 10's pipeline builds it (preset fixed, the joint stage with the range
    output and a tail term, a checkpoint every PIPE_CKPT_EVERY)."""
    from acoustic_locating_vq_vae_torch.train import make_task

    kw = dict(config=cfg, width_scale=PIPE_WIDTH, compat_vq_flatten=False, ckpt_every=PIPE_CKPT_EVERY,
              compute_dtype=compute_dtype)
    kw.update({"finetune": {"commitment_weight": 0.25}, "location": {"input_mode": "quantized"},
               "location_joint": {"predict_radius": True, "tail_weight": 0.5}}.get(stage, {}))
    return make_task(stage, **kw)


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

    if CONVERGE in sys.argv[1:]:
        converge_phase(dev, card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if OTF in sys.argv[1:]:
        otf_phase(dev, (nearest_indices_cuda, codebook_grad_cuda, codebook_stats_cuda), card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if DEPLOY in sys.argv[1:]:
        deploy_phase(dev, (nearest_indices_cuda, codebook_grad_cuda, codebook_stats_cuda), card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if KERNELS_ONLY in sys.argv[1:]:
        check_nearest(vq, nearest_indices_cuda, dev)
        check_accum(vq, codebook_grad_cuda, codebook_stats_cuda, dev)
        time_serving_kernels(dev, card)
        time_training_kernels(dev, card)
        time_stage_kernels(dev, card)
        return 0

    # ---- phase 2: kernel vs plain on the card
    max_err = check_nearest(vq, nearest_indices_cuda, dev)

    # ---- phase 3: the slice at full width, card vs CPU
    cfg = DatasetConfig()
    g = torch.Generator().manual_seed(1234)

    def specs(b, n=1):
        """Seeded echoed power spectrograms (non-negative, heavy-tailed)."""
        return [torch.empty(b, cfg.num_freq, cfg.num_frames).exponential_(generator=g) for _ in range(n)]

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
        with count_by_shape():
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

    counters = (nearest_indices_cuda, codebook_grad_cuda, codebook_stats_cuda)
    if BF16_ONLY in sys.argv[1:]:
        composite = composite_weights(make_stage_task("echoed"), torch.Generator().manual_seed(STAGE_SEED))
        stage_phase(composite, dev, counters)
        bf16_phase(dev, counters, card, composite, paths, cfg, specs)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 4: timings on the card
    serve_lat = {}
    for name, (serve_gpu, _) in outs.items():
        lat = serve_lat[name] = {}
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

    time_serving_kernels(dev, card)
    op_dispatch(dev, card, serve_lat["joint"][8])
    del outs
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()  # the capture stream's, or it counts in phase 7's peak memory
    torch.cuda.empty_cache()

    # ---- phase 5: the codebook-accumulation kernel vs plain on the card
    accum_err = check_accum(vq, codebook_grad_cuda, codebook_stats_cuda, dev)

    # ---- phase 6: the training slice at full width, card vs CPU
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
    for label, task in (("speech", SpeechVQVAETask()), ("rir", RirVQVAETask()),
                        ("speech EMA", SpeechVQVAETask(vq_ema=True))):
        trainer = Trainer(task, device=dev, seed=8, verbose=False)
        torch.cuda.reset_peak_memory_stats()
        with count_by_shape():
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

    time_training_kernels(dev, card)
    phase(7, f"launches per train step: speech {train_launches['speech']}, speech EMA {train_launches['speech EMA']}, "
             f"rir {train_launches['rir']}")

    # ---- phase 8: the composite and location stages at full width, card vs CPU
    composite = composite_weights(make_stage_task("echoed"), torch.Generator().manual_seed(STAGE_SEED))
    stage_phase(composite, dev, counters)

    # ---- phase 9: the stages' timings on the card
    stage_runs = {}
    for label, stage, cached, nearest in STAGES:
        run = time_stage(label, make_stage_task(stage), cached, composite, dev, counters, card)
        want = {"nearest_indices_cuda": nearest * run["steps"], "codebook_grad_cuda": 0, "codebook_stats_cuda": 0}
        if run["launches"] != want:
            raise AssertionError(f"{label} timed run launched {run['launches']}, want {want}")
        stage_runs[label] = run
    time_stage_kernels(dev, card)
    phase(9, "step time, ms on the card: " + ", ".join(f"{label} {run['ms']:.4f}" for label, run in stage_runs.items())
             + f"; echoed frames/s uncached {64 * 500 / stage_runs['echoed']['ms'] * 1e3:.1f}, cached "
             f"{64 * 500 / stage_runs['echoed cached']['ms'] * 1e3:.1f} ({card})")

    # ---- phase 10: the six-stage pipeline at full width, with checkpoints, preemption and resume
    pipeline_phase(dev, counters, card)

    # ---- phase 11: synthesis at the full geometry, card vs CPU float64, options, timings
    synthesis_phase(dev, card)

    # ---- phase 12: on-the-fly training with run K's options: the bank, labels, step times, the recipe
    otf_phase(dev, counters, card)

    # ---- phase 13: bf16 compute_dtype: every stage card vs CPU, step times, serving, the pipeline resumed
    bf16_phase(dev, counters, card, composite, paths, cfg, specs)

    # ---- phase 14: the deploy surface: exported artifacts loaded cold, the deploy and evaluation CLIs
    deploy_phase(dev, counters, card)

    # one entry for each kernel and shape that was timed and that the main path ran, with the launches it
    # made at that shape; every kernel of the path has an entry
    names = {"vq_nearest": ("vq_nearest.cu", 49, max_err), "vq_codebook_grad": ("vq_codebook_accum.cu", 68, accum_err),
             "vq_codebook_stats": ("vq_codebook_accum.cu", 150, accum_err)}
    entries = [{"name": name, "route": "cuda", "source": f"src/acoustic_locating_vq_vae_torch/csrc/{names[name][0]}",
                "replaces": f"src/acoustic_locating_vq_vae_tpu/ops/vq_pallas.py:{names[name][1]}",
                "shape": f"N={n}, D={d}, K={k}", "launches": SHAPE_LAUNCHES[(name, n, d, k)],
                "max_abs_err": names[name][2], **timing}
               for (name, n, d, k), timing in sorted(SHAPE_TIMINGS.items(), key=lambda kv: (list(names).index(kv[0][0]),
                                                                                           kv[0][1:]))
               if SHAPE_LAUNCHES[(name, n, d, k)] > 0]
    missing = set(names) - {e["name"] for e in entries}
    if missing:
        raise AssertionError(f"no timed shape of {sorted(missing)} was launched by the main path: {dict(SHAPE_LAUNCHES)}")
    phase(10, "launches of the main path's checked and timed runs by kernel and shape: "
             + ", ".join(f"{name} ({n}, {d}, {k}) {c}" for (name, n, d, k), c in sorted(SHAPE_LAUNCHES.items())))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
