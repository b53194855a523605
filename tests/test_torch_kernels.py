"""The port's hand-written kernels on the card, against their plain PyTorch
versions. The ``cuda`` tests need a CUDA card and skip without one; the
others check, on the CPU, that the wrappers and entry points refuse to work
without a card. This file imports no JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX.) ``chip_smoke.py``
holds the same kernels at full width."""

import copy

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.dsp import znorm
from acoustic_locating_vq_vae_torch.eval import evaluate_joint_location, evaluate_location, full_fp32, make_serving_fn
from acoustic_locating_vq_vae_torch.ops import vq
from acoustic_locating_vq_vae_torch.ops.vq_cuda import codebook_grad_cuda, codebook_stats_cuda, nearest_indices_cuda
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask, EncoderFinetuneTask, JointLocationTask, LocationTask, Preempted, SpeechVQVAETask, Trainer,
    run_pipeline,
)

SHAPES = [(512, 128, 1024), (100, 4, 16), (1000, 64, 1024), (513, 128, 100), (12864, 64, 1024),
          # the kernel's other branches: the codebook split over a cluster (N = 1,608), K off and below a
          # code tile, D off the 16-byte pieces, D above the resident x tile
          (1608, 64, 1024), (1608, 64, 100), (1608, 64, 16), (1000, 129, 300), (300, 6, 1024), (2000, 256, 520)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_kernel_matches_plain_on_card(card, n, d, k):
    """Equal indices, except rows whose two codes tie in float64 to 1e-6 of
    the squared norms (cuBLAS sums in another order), at most 0.1% of rows."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
    cb = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(card)
    e2 = (cb * cb).sum(1)
    with full_fp32():
        got = nearest_indices_cuda(x, cb, e2).long().cpu()
        want = vq.nearest_indices(x, cb, e2).cpu()
    rows = torch.nonzero(got != want).flatten()
    x64, cb64 = x.cpu().double()[rows], cb.cpu().double()
    gap = (((x64 - cb64[got[rows]]) ** 2).sum(1) - ((x64 - cb64[want[rows]]) ** 2).sum(1)).abs()
    scale = (x64**2).sum(1) + (cb64**2).sum(1).max()
    assert bool((gap <= 1e-6 * scale).all())
    assert rows.numel() <= 1e-3 * n


@pytest.mark.cuda
def test_kernel_ties_take_the_first_index(card):
    got = nearest_indices_cuda(torch.ones(70, 4, device=card), torch.ones(90, 4, device=card), torch.full((90,), 4.0, device=card))
    assert torch.equal(got.cpu(), torch.zeros(70, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1608, 64, 1024), (12864, 64, 1024), (700, 129, 300)])
def test_two_launches_give_equal_indices(card, n, d, k):
    """Also where the codebook is split over a cluster (N = 1,608): the merge
    does not depend on the order in which the blocks finish."""
    g = torch.Generator().manual_seed(n)
    x, cb = torch.randn(n, d, generator=g).to(card), torch.randn(k, d, generator=g).to(card)
    e2 = (cb * cb).sum(1)
    first = nearest_indices_cuda(x, cb, e2)
    for _ in range(3):
        assert torch.equal(first, nearest_indices_cuda(x, cb, e2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1608, 12864], ids=["split_codebook", "one_slice"])
def test_duplicated_codebook_rows_take_the_lower_index_on_card(card, n):
    """Every code twice, the copy in the upper half, which another block of
    the cluster scans at N = 1,608: no row may take the copy."""
    g = torch.Generator().manual_seed(1)
    x, half = torch.randn(n, 64, generator=g).to(card), torch.randn(512, 64, generator=g).to(card)
    cb = torch.cat([half, half])
    got = nearest_indices_cuda(x, cb, (cb * cb).sum(1))
    assert int(got.max()) < 512
    with full_fp32():
        want = vq.nearest_indices(x, half, (half * half).sum(1))
    assert int((got.long() != want).sum()) <= 1e-3 * n  # near ties between summation orders only


@pytest.mark.cuda
def test_zero_scores_and_nan_rows_on_card(card):
    """+0.0 and -0.0 are equal scores (the lower code wins), all ties across
    the cluster's slices go to code 0, and a row of NaN takes code 0."""
    g = torch.Generator().manual_seed(2)
    cb = (torch.randn(1024, 64, generator=g) + 3.0).to(card)
    cb[3] = 0.0
    cb[700] = 0.0
    e2 = (cb * cb).sum(1)
    e2[700] = -0.0
    got = nearest_indices_cuda(torch.zeros(1608, 64, device=card), cb, e2)
    assert torch.equal(got.cpu(), torch.full((1608,), 3, dtype=torch.int32))
    ones = nearest_indices_cuda(torch.ones(1608, 64, device=card), torch.ones(1024, 64, device=card),
                                torch.full((1024,), 64.0, device=card))
    assert torch.equal(ones.cpu(), torch.zeros(1608, dtype=torch.int32))
    x = torch.randn(300, 64, generator=g).to(card)
    x[7] = float("nan")
    cb = torch.randn(1024, 64, generator=g).to(card)
    assert int(nearest_indices_cuda(x, cb, (cb * cb).sum(1))[7]) == 0


@pytest.mark.cuda
def test_kernel_launch_is_counted_and_assign_uses_it(card):
    x = torch.randn(300, 8, device=card)
    cb = torch.randn(20, 8, device=card)
    before = nearest_indices_cuda.launches
    idx, q = vq.assign(x, cb)
    assert nearest_indices_cuda.launches == before + 1
    assert torch.equal(q, cb[idx])
    with pytest.raises(ValueError, match="float32"):
        nearest_indices_cuda(x.double(), cb, (cb * cb).sum(1))
    with pytest.raises(ValueError, match="contiguous"):
        nearest_indices_cuda(x.T.contiguous().T, cb, (cb * cb).sum(1))


def _latent_codebook_(rir, spec, g):
    """Replace the codebook by pre-VQ latent rows: an untrained U(+-1/K)
    codebook makes the argmin a near-tie lottery."""
    with torch.no_grad():
        z = rir.pre_vq_latent(znorm(spec, dim=1).transpose(1, 2))
        rows = (z if rir.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, rir.embedding_dim)
        pick = torch.randperm(rows.shape[0], generator=g)[: rir.num_embeddings]
        rir._vq._embedding.weight.copy_(rows[pick])


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "frozen"])
def test_serving_on_card_matches_cpu(card, frozen):
    """The serving path at width 1/16 on the card agrees with the CPU."""
    g = torch.Generator().manual_seed(0)
    cfg = DatasetConfig()
    spec, other = torch.empty(2, 4, 201, 500).exponential_(generator=g)
    if frozen:
        task = LocationTask(width_scale=1 / 16)
        rir = task.build_rir_model(g)
        _latent_codebook_(rir, other, g)
        params, comp = task.build_model(g).state_dict(), rir.state_dict()
    else:
        task = JointLocationTask(width_scale=1 / 16, predict_radius=True)
        model = task.build_model(g)
        _latent_codebook_(model.rir_model, other, g)
        params, comp = model.state_dict(), None
    before = nearest_indices_cuda.launches
    got = make_serving_fn(task, params, cfg, comp, device=card)(spec)
    assert nearest_indices_cuda.launches == before + 1
    want = make_serving_fn(task, params, cfg, comp, device="cpu")(spec)
    for a, b in zip(got, want):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_exported_artifact_on_card_calls_the_kernel(card, tmp_path):
    """The joint localizer exported on the card at width 1/16: its graph
    holds the registered operator and no argmin, each call of the loaded
    artifact launches the kernel once, and it agrees with the live closure."""
    from acoustic_locating_vq_vae_torch.eval import export_localizer, load_localizer

    g = torch.Generator().manual_seed(1)
    spec, other = torch.empty(2, 8, 201, 500).exponential_(generator=g)
    task = JointLocationTask(width_scale=1 / 16, predict_radius=True)
    model = task.build_model(g)
    _latent_codebook_(model.rir_model, other, g)
    params, cfg = model.state_dict(), DatasetConfig()
    serve = make_serving_fn(task, params, cfg, device=card)
    meta = export_localizer(task, params, cfg, str(tmp_path), serve_fn=serve)
    assert meta["platforms"] == ["cuda"]
    call, _ = load_localizer(str(tmp_path))
    targets = [str(n.target) for n in call.module.graph.nodes if n.op == "call_function"]
    assert targets.count("acoustic_locating_vq_vae_torch.vq_nearest.default") == 1
    assert not [t for t in targets if "argmin" in t]
    before = nearest_indices_cuda.launches
    got = call(spec)
    assert nearest_indices_cuda.launches == before + 1
    for a, b in zip(got, serve(spec)):
        assert a.is_cuda
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


# the shapes of chip_smoke.py phase 5: speech, RIR, ragged, D not a multiple of 32
ACCUM_SHAPES = [(16000, 128, 1024), (6432, 64, 1024), (100, 4, 16), (513, 129, 100)]


# few codes in use, as early in training; D = 4 and D = 129 over several scan rounds
ACCUM_FEW = [(16000, 128, 1024, "one code"), (16000, 128, 1024, "32 codes"), (3000, 129, 1024, "32 codes"),
             (20000, 4, 64, "32 codes"), (70001, 30, 9, "uniform")]


def _accum_inputs(n, d, k, card, kind="uniform"):
    g = torch.Generator().manual_seed(n + d + k)
    x = torch.randn(n, d, generator=g).to(card)
    if kind == "one code":
        idx = torch.full((n,), 3, dtype=torch.int32)
    elif kind == "32 codes":
        used = torch.randperm(k, generator=g)[:32].to(torch.int32)
        idx = used[torch.randint(0, 32, (n,), generator=g)]
    else:
        idx = torch.randint(0, k, (n,), generator=g, dtype=torch.int32)
    return idx.to(card), x


def _close(got, want):
    """max |kernel - plain| <= 1e-5 * max(1, max |plain|): the kernel sums
    FP32 rows per code in its own order."""
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,kind", [s + ("uniform",) for s in ACCUM_SHAPES] + ACCUM_FEW,
                         ids=[f"{n}x{d}x{k}" for n, d, k in ACCUM_SHAPES] + ["skewed"]
                         + [f"{n}x{d}x{k}-{kind.replace(' ', '_')}" for n, d, k, kind in ACCUM_FEW[1:]])
def test_codebook_accum_matches_plain_and_is_deterministic(card, n, d, k, kind):
    idx, x = _accum_inputs(n, d, k, card, kind)
    grad = codebook_grad_cuda(idx, x, k)
    counts, sums = codebook_stats_cuda(idx, x, k)
    # the plain version in float64: its FP32 index_add_ on the card sums by
    # atomics in no fixed order, which alone moves a skewed sum by ~1e-5
    want_counts, want_sums = vq.codebook_stats_plain(idx, x.double(), k)
    _close(grad, want_sums)
    _close(sums, want_sums)
    assert torch.equal(counts, want_counts)
    assert torch.equal(grad, codebook_grad_cuda(idx, x, k))
    again = codebook_stats_cuda(idx, x, k)
    assert torch.equal(counts, again[0]) and torch.equal(sums, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [False, True], ids=["gradient", "statistics"])
def test_codebook_accum_allocates_no_scratch(card, with_counts):
    """One launch into one allocation: the call's peak memory is its result."""
    n, d, k = 16000, 128, 1024
    idx, x = _accum_inputs(n, d, k, card)
    fn = codebook_stats_cuda if with_counts else codebook_grad_cuda
    fn(idx, x, k)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(idx, x, k)
    torch.cuda.synchronize()
    result_bytes = 4 * (k * d + (k if with_counts else 0))
    assert torch.cuda.max_memory_allocated() - before <= result_bytes + 512  # the allocator rounds to 512 bytes
    assert torch.cuda.memory_allocated() - before <= result_bytes + 512
    del out


@pytest.mark.cuda
def test_codebook_accum_skips_indices_out_of_range(card):
    idx = torch.randint(-3, 20, (5000,), dtype=torch.int32).to(card)
    x = torch.randn(5000, 8).to(card)
    keep = (idx >= 0) & (idx < 16)
    _close(codebook_grad_cuda(idx, x, 16), vq.codebook_grad_plain(idx[keep], x[keep].double(), 16))


@pytest.mark.cuda
@pytest.mark.parametrize("ema", [False, True], ids=["gradient", "ema"])
def test_train_step_on_card_matches_cpu(card, ema):
    """One speech train step at width 1/16 on the card and on the CPU from
    the same seed, batch and jitter decisions: the same loss and EMA
    buffers, every card gradient within 1e-3 of its largest entry from the
    same step in float64, and the card's launches went through the kernels."""
    task = SpeechVQVAETask(width_scale=1 / 16, batch_size=2, vq_ema=ema)
    g = torch.Generator().manual_seed(0)
    spec = torch.empty(2, 201, 64).exponential_(generator=g)
    batch = SampleBatch(spec, spec, spec, torch.zeros(2), torch.zeros(2), torch.zeros(2, 201), torch.ones(2))
    model = task.build_model(torch.Generator().manual_seed(1))
    (x,) = task.model_inputs(batch)
    with torch.no_grad():
        rows = model.pre_vq_latent(x).reshape(-1, model.embedding_dim)
    cb = rows[torch.randperm(rows.shape[0], generator=g)[: model.num_embeddings]]
    runs = {}
    for dev in ("cpu", card):
        trainer = Trainer(task, device=dev, seed=1, verbose=False)
        with torch.no_grad():
            trainer.model._vq._embedding.weight.copy_(cb)
            if ema:
                trainer.model._vq.ema_sums.copy_(cb)
        if dev == "cpu":
            ref = copy.deepcopy(trainer.model).double()
            jitter = torch.Generator()
            jitter.set_state(trainer.jitter_generator.get_state())
        counter = codebook_stats_cuda if ema else codebook_grad_cuda
        before = counter.launches
        metrics = trainer.step(trainer.sample(trainer.to_device(batch)))
        if dev == card:
            assert counter.launches == before + 1
        grads = {k: p.grad.cpu() for k, p in trainer.model.named_parameters()}
        runs[str(dev)] = (metrics, grads, {k: b.cpu() for k, b in trainer.model.named_buffers()})
    loss64, _ = task.loss(ref, batch.map(lambda a: a.double()), True, jitter)
    loss64.backward()
    (m_cpu, _, b_cpu), (m_gpu, g_gpu, b_gpu) = runs["cpu"], runs[str(card)]
    torch.testing.assert_close(m_gpu["loss"].cpu(), m_cpu["loss"], rtol=1e-4, atol=0)
    for key, p in ref.named_parameters():
        assert float((g_gpu[key].double() - p.grad).abs().max()) <= 1e-3 * float(p.grad.abs().max()), key
    for key, v in b_cpu.items():  # the latents differ by conv rounding
        assert float((b_gpu[key] - v).abs().max()) <= 1e-4 * max(1.0, float(v.abs().max())), key


# (stage, cached, vq_nearest launches of one train step); the codebooks are
# frozen in all four stages, so the accumulation kernel never runs
STAGE_LAUNCHES = [("echoed", False, 2), ("echoed", True, 0), ("finetune", False, 2), ("location", False, 1),
                  ("location", True, 0), ("location_joint", False, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("stage,cached,nearest", STAGE_LAUNCHES,
                         ids=[f"{s}-{'cached' if c else 'uncached'}" for s, c, _ in STAGE_LAUNCHES])
def test_stage_step_launches_on_card(card, stage, cached, nearest):
    """One train step of each composite and location stage at width 1/16 on
    the card: a finite loss, ``nearest`` vq_nearest launches (one per frozen
    branch the step runs) and no codebook-gradient or statistics launch."""
    g = torch.Generator().manual_seed(3)
    spec = torch.empty(4, 201, 500).exponential_(generator=g)
    data = SampleBatch(spec, spec, spec, torch.zeros(4), torch.rand(4, generator=g), torch.ones(4, 201), torch.ones(4))
    ws = dict(width_scale=1 / 16, batch_size=2)
    composite = EchoedSpeechTask(**ws).build_model(g).state_dict()
    task = {"echoed": EchoedSpeechTask(**ws), "finetune": EncoderFinetuneTask(**ws), "location": LocationTask(**ws),
            "location_joint": JointLocationTask(predict_radius=True, tail_weight=0.5, **ws)}[stage]
    trainer = Trainer(task, device=card, seed=0, verbose=False,
                      composite_params=composite if stage == "location" else None)
    data = trainer.to_device(data)
    cache = trainer.build_cache(data) if cached else None
    batch, rows = trainer.sample_cached(data, cache) if cached else (trainer.sample(data), None)
    counters = (nearest_indices_cuda, codebook_grad_cuda, codebook_stats_cuda)
    torch.cuda.synchronize()
    before = [c.launches for c in counters]
    metrics = trainer.step(batch, cache=rows)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [nearest, 0, 0]
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
def test_preempt_and_resume_on_card_is_bitwise(card, tmp_path):
    """A speech stage at width 1/16 on the card, preempted during its 3rd of
    6 updates and resumed from its checkpoint by a fresh trainer, ends with
    the weights, Adam state and generators of an uninterrupted run, bitwise."""
    g = torch.Generator().manual_seed(5)
    spec = torch.empty(16, 201, 500).exponential_(generator=g)
    data = SampleBatch(spec, spec, spec, torch.zeros(16), torch.zeros(16), torch.ones(16, 201), torch.ones(16))
    task = SpeechVQVAETask(width_scale=1 / 16, batch_size=8, ckpt_every=2)
    make = lambda store: Trainer(task, device=card, seed=4, verbose=False, checkpoint_dir=str(tmp_path / store))
    straight = make("a")
    straight.fit(data, num_updates=6)
    preempted = make("b")
    step = preempted.step

    def stepping(*args, **kw):
        if preempted.step_count == 2:
            preempted.request_preemption()  # as a SIGTERM during the 3rd update does
        return step(*args, **kw)

    preempted.step = stepping
    with pytest.raises(Preempted):
        preempted.fit(data, num_updates=6)
    resumed = make("b")
    resumed.fit(data, num_updates=6, resume=True)
    assert resumed.step_count == 6
    assert_bitwise(resumed.model.state_dict(), straight.model.state_dict(), "model")
    assert_bitwise(resumed.optimizer.state_dict(), straight.optimizer.state_dict(), "adam")
    assert torch.equal(resumed.sample_generator.get_state(), straight.sample_generator.get_state())
    assert torch.equal(resumed.jitter_generator.get_state(), straight.jitter_generator.get_state())


def assert_bitwise(got, want, path="state"):
    """Bitwise equality of nested dicts / lists of tensors and numbers (state
    dicts, Adam's state, checkpoints)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_bitwise(a, b, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), path
    else:
        assert got == want, (path, got, want)


def test_pipeline_entry_points_without_a_card_raise(monkeypatch):
    """run_pipeline, evaluate_location and evaluate_joint_location run on the
    card unless asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = torch.ones(2, 201, 500)
    data = SampleBatch(spec, spec, spec, torch.zeros(2), torch.zeros(2), torch.ones(2, 201), torch.ones(2))
    ws = dict(width_scale=1 / 32)
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline(0, data, None, width_scale=1 / 32)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_location(LocationTask(**ws), {}, {}, data)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_joint_location(JointLocationTask(**ws), {}, data)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers never compute on the CPU: they raise and count
    no launch."""
    idx = torch.zeros(10, dtype=torch.int32)
    x = torch.randn(10, 4)
    counts = (nearest_indices_cuda.launches, codebook_grad_cuda.launches, codebook_stats_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        codebook_grad_cuda(idx, x, 6)
    with pytest.raises(ValueError, match="CUDA"):
        codebook_stats_cuda(idx, x, 6)
    with pytest.raises(ValueError, match="CUDA"):
        nearest_indices_cuda(x, x[:6], (x[:6] ** 2).sum(1))
    assert counts == (nearest_indices_cuda.launches, codebook_grad_cuda.launches, codebook_stats_cuda.launches)


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(SpeechVQVAETask(width_scale=1 / 32))
