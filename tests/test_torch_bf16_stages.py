"""The port's bf16 ``compute_dtype`` in the composite and location stages
against the JAX package's ``compute_dtype="bfloat16"`` on the CPU: the echoed
stage (frozen branches), the fine-tune stage (encoders trained, with and
without the commitment anchor), the frozen location stage (one-hot encodings
and quantized latents of its bf16 RIR branch into the float32 head) and the
joint stage (bf16 RIR encoder, float32 head, range output and tail term):
loss, metrics and every gradient, and the frozen-latent cache in bf16. Then
the trainer under a bf16 task (checkpoints, resume, a bf16-stored dataset), a
bf16 stage's store read by a float32 task and back, ``run_pipeline`` and the
CLI's ``--compute-dtype``.

The criterion, the distance, the two corrections of XLA-CPU's reference (bias
gradients summed in float32; the quantizers fed the port's latent straight
through) and the code rules are ``test_torch_bf16.py``'s. Weights are drawn
by the JAX package at width 1/32 on the 33 bins x 64 frames geometry and
carried across by ``composite_params_from_jax`` / ``params_from_jax``; each
codebook is made of the port's bf16 branch's latent rows of a separate batch.

Readings (the worst ratio, port-vs-JAX-bf16 over JAX-bf16-vs-float32,
over the loss, metrics and every gradient, seeds 0, 1, 2; recorded when the
tests were written): echoed 0.0068, 2.6e-5, 0.038; finetune 0.025, 2.6e-5,
0.038; finetune anchored 0.058, 2.9e-4, 0.038; location with encodings
1.1e-4, 0, 3.5e-6 and with quantized latents 1.3e-5, 0, 7.9e-5 (0: JAX bf16
within F32_REL of JAX float32, the port's within it too); joint 0.0032,
0.0046, 0.0039. The cached bf16 loss against the uncached one: 0 in both
stages at every seed (``CACHE_RTOL``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_torch.data import DatasetConfig
from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax, params_from_jax
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask,
    EncoderFinetuneTask,
    JointLocationTask,
    LocationTask,
    SpeechVQVAETask,
    Trainer,
    run_pipeline,
)
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_torch_bf16 import (
    SEEDS,
    TASKS,
    WS,
    _batch,
    _codes_check,
    _np,
    assert_closer,
    jax_batch,
    jax_codes,
    jax_init,
    jax_value_and_grad,
    port_vq_inputs,
    torch_batch,
)

GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames
DTYPES = ("float32", "bfloat16")
# the cached bf16 loss against the uncached one on the same weights and batch, read 0 at every seed: the decoder
# reads the codebook rows either way, and the straight-through value's last float32 bit is rounded away by bf16
CACHE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The widths here are tiny: torch's CPU convolutions spend milliseconds
    a call starting a pool of every core, and microseconds on four."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def batch(b, seed):
    return _batch(b, T, seed, f=F)


def _latent_rows(branch, x, seed):
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def composite(seed, flatten=True):
    """JAX composite params grafted from freshly drawn speech and RIR stages,
    each codebook made of the port's bf16 branch's latent rows: (params, the
    port's bf16 echoed task and model on them)."""
    kw = dict(config=JSMALL, width_scale=WS, compat_vq_flatten=flatten)
    x, x_rir = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
    key = ("composite", flatten)
    p = jax_init(jtrain.EchoedSpeechTask(**kw).build_model(), (x, x_rir), seed, key)["params"]
    speech = jax_init(jtrain.SpeechVQVAETask(**kw).build_model(), x, seed + 10, key + ("speech",))["params"]
    rir = jax_init(jtrain.RirVQVAETask(**kw).build_model(), x_rir, seed + 20, key + ("rir",))["params"]
    p = _np(jtrain.graft_pretrained(p, speech, rir))
    task = EchoedSpeechTask(config=SMALL, width_scale=WS, compat_vq_flatten=flatten, compute_dtype="bfloat16")
    model = task.build_model()
    model.load_state_dict(composite_params_from_jax(p))
    xs, xr = task.model_inputs(torch_batch(batch(2, 600 + seed)))
    p["speech_model"]["_vq"]["codebook"] = _latent_rows(model.speech_model, xs, 610 + seed)
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, xr, 620 + seed)
    model.load_state_dict(composite_params_from_jax(p))
    return p, task, model


def _compare_grads(model, want16, want32, what):
    """Every parameter with a gradient by the criterion; a parameter without
    one has an exactly zero gradient in JAX bf16. Returns the worst ratio."""
    worst = 0.0
    for k, prm in model.named_parameters():
        if prm.grad is None:
            assert not want16[k].any(), f"{what} {k}: no gradient in the port, a nonzero one in JAX"
            continue
        assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32
        worst = max(worst, assert_closer(prm.grad, want16[k], want32[k], f"{what} gradient {k}"))
    return worst


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stage,commitment_weight", [("echoed", 0.0), ("finetune", 0.0), ("finetune", 0.25)],
                         ids=["echoed", "finetune", "finetune_anchored"])
def test_composite_stage_matches_jax_bf16(stage, commitment_weight, seed):
    """Loss, metrics and every gradient (train=False: no jitter) against JAX
    bf16; the codes of both frozen branches by the code rules."""
    p, task, model = composite(seed)
    cls, jcls = {"echoed": (EchoedSpeechTask, jtrain.EchoedSpeechTask),
                 "finetune": (EncoderFinetuneTask, jtrain.EncoderFinetuneTask)}[stage]
    task = cls(config=SMALL, width_scale=WS, commitment_weight=commitment_weight, compute_dtype="bfloat16")
    d = batch(3, 630 + seed)
    x, x_rir = task.model_inputs(torch_batch(d))
    vq_in = port_vq_inputs(model, lambda: model(x, x_rir, train=False))
    runs = {}
    for dt in DTYPES:
        jt = jcls(config=JSMALL, width_scale=WS, commitment_weight=commitment_weight, compute_dtype=dt)
        jm = jt.build_model()

        def loss_fn(params, b, jt=jt, jm=jm):
            return jt.loss(jm, params, b, {}, False)

        (loss, metrics), grads = jax_value_and_grad(loss_fn, p, dt == "bfloat16", vq_in, (jax_batch(d),),
                                                    key=(stage, commitment_weight))
        xj, xj_rir = jt.model_inputs(jax_batch(d))
        codes = jax_codes(jm, {"params": p}, (xj, xj_rir), (stage, commitment_weight, dt), "encode_codes")
        runs[dt] = float(loss), metrics, composite_params_from_jax(_np(grads)), codes
    r16, r32 = runs["bfloat16"], runs["float32"]
    with torch.no_grad():
        codes = model.encode_codes(x, x_rir)
    for branch, inp, key in ((model.speech_model, x, "speech_codes"), (model.rir_model, x_rir, "rir_codes")):
        _codes_check(branch, inp, codes[key].numpy(), r16[3][key], r32[3][key], f"{stage} {key}")
    loss, metrics = task.loss(model, torch_batch(d), False)
    loss.backward()
    assert_closer(loss.item(), r16[0], r32[0], "loss")
    assert set(metrics) == set(r16[1])
    assert_closer(metrics["recon_error"].item(), float(r16[1]["recon_error"]), float(r32[1]["recon_error"]), "recon")
    for k in ("speech_perplexity", "rir_perplexity"):  # from the codes alone
        np.testing.assert_allclose(metrics[k].item(), float(r16[1][k]), rtol=1e-6, err_msg=k)
    _compare_grads(model, r16[2], r32[2], stage)
    trained = {k.split(".")[0] for k, prm in model.named_parameters() if prm.grad is not None}
    assert trained == ({"_decoder", "speech_model", "rir_model"} if stage == "finetune" else {"_decoder"})


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("input_mode", ["encodings", "quantized"])
def test_location_stage_matches_jax_bf16(input_mode, seed):
    """The frozen stage: its bf16 RIR branch's features into the float32
    head; the head's loss and every gradient against JAX bf16, the features
    against JAX bf16's, the cached features equal to the uncached ones."""
    p, _, comp = composite(seed)
    kw = dict(width_scale=WS, input_mode=input_mode)
    width = 32 if input_mode == "encodings" else 4  # K or D of the RIR branch
    head_p = jax_init(jtrain.LocationTask(config=JSMALL, **kw).build_model(), jnp.zeros((1, F, width)), seed,
                      ("location", input_mode))["params"]
    task = LocationTask(config=SMALL, compute_dtype="bfloat16", **kw)
    rir = task.build_frozen(comp.state_dict(), torch.device("cpu"))
    head = task.build_model()
    head.load_state_dict(params_from_jax(head_p))
    d = batch(4, 640 + seed)
    tb = torch_batch(d)
    vq_in = port_vq_inputs(rir, lambda: task.frozen_features(rir, tb))
    runs = {}
    for dt in DTYPES:
        jt = jtrain.LocationTask(config=JSMALL, compute_dtype=dt, **kw)
        jcomp, jhead = jt.build_composite(), jt.build_model()

        def loss_fn(hp, cp, b, jt=jt, jcomp=jcomp, jhead=jhead):
            enc = jt.encodings_from_composite(jcomp, cp, b)
            loss, metrics = jt.loss(jhead, hp, b, {}, True, encodings=enc)
            return loss, (metrics, enc)

        (loss, (metrics, enc)), grads = jax_value_and_grad(loss_fn, head_p, dt == "bfloat16", vq_in,
                                                           (p, jax_batch(d)), key=("location", input_mode))
        runs[dt] = float(loss), metrics, params_from_jax(_np(grads)), np.asarray(enc)
    r16, r32 = runs["bfloat16"], runs["float32"]
    feats = task.frozen_features(rir, tb)
    assert feats.dtype == torch.float32
    if input_mode == "encodings":  # one-hot of the same codes (the VQ reads the port's latent in both)
        np.testing.assert_array_equal(feats.numpy(), r16[3])
    else:
        np.testing.assert_allclose(feats.numpy(), r16[3], rtol=1e-6, atol=1e-7)
    cached = task.frozen_features(rir, tb, task.build_cache(rir, tb))
    assert torch.equal(cached, feats)
    loss, metrics = task.loss(head, tb, True, feats=feats)
    loss.backward()
    assert_closer(loss.item(), r16[0], r32[0], "loss")
    _compare_grads(head, r16[2], r32[2], "location")


@pytest.mark.parametrize("seed", SEEDS)
def test_joint_stage_matches_jax_bf16(seed):
    """The joint stage (sincos with the range output and a tail term): loss,
    metrics and every gradient against JAX bf16; the bf16 RIR encoder learns
    through the straight-through estimator into the float32 head."""
    kw = dict(width_scale=WS, predict_radius=True, tail_weight=0.5)
    p = jax_init(jtrain.JointLocationTask(config=JSMALL, **kw).build_model(), jnp.zeros((1, T, F)), seed,
                 ("joint",))["params"]
    task = JointLocationTask(config=SMALL, compute_dtype="bfloat16", **kw)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    (xs,) = task.model_inputs(torch_batch(batch(2, 650 + seed)).echoed_spec)
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, xs, 660 + seed)
    model.load_state_dict(params_from_jax(p))
    d = batch(8, 670 + seed)  # tail over ceil(8 / 8) = 1 sample
    (x,) = task.model_inputs(torch_batch(d).echoed_spec)
    vq_in = port_vq_inputs(model, lambda: model(x))
    runs = {}
    for dt in DTYPES:
        jt = jtrain.JointLocationTask(config=JSMALL, compute_dtype=dt, **kw)
        jm = jt.build_model()

        def loss_fn(params, b, jt=jt, jm=jm):
            return jt.loss(jm, params, b, {}, True)

        (loss, metrics), grads = jax_value_and_grad(loss_fn, p, dt == "bfloat16", vq_in, (jax_batch(d),),
                                                    key=("joint",))
        runs[dt] = float(loss), metrics, params_from_jax(_np(grads))
    r16, r32 = runs["bfloat16"], runs["float32"]
    loss, metrics = task.loss(model, torch_batch(d), True)
    loss.backward()
    assert_closer(loss.item(), r16[0], r32[0], "loss")
    assert set(metrics) == set(r16[1])
    for k in ("location_error", "tail_error", "radius_error"):
        assert_closer(metrics[k].item(), float(r16[1][k]), float(r32[1][k]), k)
    assert model.rir_model._vq._embedding.weight.grad is None
    assert all(prm.dtype == torch.float32 for prm in model.head.parameters())
    _compare_grads(model, r16[2], r32[2], "joint")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stage", ["echoed", "location"])
def test_bf16_cached_loss_equals_uncached(stage, seed):
    """A bf16 trainer's frozen-latent cache (built in chunks, as ``fit``
    builds it) holds the codes of the same bf16 frozen branches, and the
    cached train loss equals the uncached one within CACHE_RTOL on the same
    weights, batch and jitter decisions."""
    p, _, comp = composite(seed)
    if stage == "echoed":
        task = EchoedSpeechTask(config=SMALL, width_scale=WS, batch_size=4, compute_dtype="bfloat16")
        tr = Trainer(task, device="cpu", seed=seed, verbose=False, cache_frozen=True)
        tr.model.load_state_dict(comp.state_dict())
    else:
        task = LocationTask(config=SMALL, width_scale=WS, batch_size=4, compute_dtype="bfloat16")
        tr = Trainer(task, device="cpu", seed=seed, verbose=False, cache_frozen=True, composite_params=comp.state_dict())
    data = torch_batch(batch(12, 680 + seed))
    cache = tr.build_cache(data)
    assert all(v.dtype == torch.int32 for v in cache.values())
    b, rows = tr.sample_cached(data, cache)
    with torch.no_grad():
        for k, v in tr.task.step_cache(tr.model, tr.frozen_rir, b).items():
            assert torch.equal(v, rows[k]), k
        state = tr.jitter_generator.get_state()
        uncached = tr._loss(b, True, None)[0].item()
        tr.jitter_generator.set_state(state)
        cached = tr._loss(b, True, rows)[0].item()
    assert abs(cached - uncached) <= CACHE_RTOL * abs(uncached), (cached, uncached)


# ---------------------------------------------------------------- the trainer, the store, the pipeline, the CLI


def _small_sets(dtype=torch.float32):
    train = torch_batch(_batch(12, SMALL.num_frames, 500, f=SMALL.num_freq))
    val = torch_batch(_batch(6, SMALL.num_frames, 501, f=SMALL.num_freq))
    cast = lambda a: a.to(dtype) if a.is_floating_point() and a.dim() > 1 else a
    return train.map(cast), val.map(cast)


def test_bf16_trainer_checkpoints_resume_and_cross_dtype_store(tmp_path):
    """A bf16 speech stage: parameters and Adam's state stay float32; a run
    preempted after 3 of 6 steps resumes bitwise equal to a straight run; its
    final loads into a float32 task's trainer and a float32 final into a bf16
    one."""
    train, val = _small_sets()
    task = SpeechVQVAETask(config=SMALL, width_scale=WS, batch_size=4, eval_every=4, ckpt_every=3,
                           compute_dtype="bfloat16")
    straight = Trainer(task, device="cpu", seed=3, verbose=False, checkpoint_dir=str(tmp_path / "a"))
    straight.fit(train, val, num_updates=6)
    assert all(p.dtype == torch.float32 for p in straight.model.parameters())
    assert all(t.dtype == torch.float32 for s in straight.optimizer.state.values() for t in s.values()
               if t.is_floating_point() and t.dim() > 0)
    part = Trainer(task, device="cpu", seed=3, verbose=False, checkpoint_dir=str(tmp_path / "b"))
    part.fit(train, val, num_updates=3, save_final=False)
    resumed = Trainer(task, device="cpu", seed=3, verbose=False, checkpoint_dir=str(tmp_path / "b"))
    resumed.fit(train, val, num_updates=6, resume=True)
    a, b = StageStore(str(tmp_path / "a")).load_stage("speech"), StageStore(str(tmp_path / "b")).load_stage("speech")
    for k, v in a["model"].items():
        assert v.dtype == torch.float32 and torch.equal(v, b["model"][k]), k
    f32 = Trainer(dataclasses.replace(task, compute_dtype="float32"), device="cpu", seed=4, verbose=False)
    f32.model.load_state_dict(a["model"])
    f32_final = Trainer(dataclasses.replace(task, compute_dtype="float32"), device="cpu", seed=5, verbose=False,
                        checkpoint_dir=str(tmp_path / "c"))
    f32_final.fit(train, None, num_updates=2)
    back = Trainer(task, device="cpu", seed=6, verbose=False)
    back.model.load_state_dict(StageStore(str(tmp_path / "c")).load_stage("speech")["model"])
    assert torch.equal(back.model._encoder._conv_1.weight, f32_final.model._encoder._conv_1.weight)


def test_bf16_stored_dataset_trains_as_its_float32_copy():
    """A bf16 echoed stage with the cache on a bf16-stored dataset: the rows
    are cast to float32 per batch (and the cache's chunks alike), then to
    bf16 by the first conv, so it trains bitwise as the float32 copy of the
    same values (JAX ``loop.py:444-450``)."""
    train, _ = _small_sets()
    task = EchoedSpeechTask(config=SMALL, width_scale=WS, batch_size=4, compute_dtype="bfloat16")
    stored, _ = _small_sets(torch.bfloat16)
    rounded = train.map(lambda a: a.to(torch.bfloat16).float() if a.is_floating_point() and a.dim() > 1 else a)
    runs = []
    for data in (stored, rounded):
        tr = Trainer(task, device="cpu", seed=8, verbose=False, cache_frozen=True)
        runs.append(tr.fit(data, None, num_updates=3).finalize()["train"]["loss"])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.isfinite(runs[0]).all()


def test_run_pipeline_bf16_resumes_and_skips(tmp_path, capsys, monkeypatch):
    """run_pipeline(compute_dtype="bfloat16") at width 1/32: every stage's
    task in bf16, every final float32; rerun with resume=True, every stage is
    skipped and the finals stay bitwise."""
    train, val = _small_sets()
    built = []
    make = Trainer.__init__

    def recording(self, task, *a, **kw):
        built.append((task.name, task.compute_dtype))
        make(self, task, *a, **kw)

    kw = dict(store_dir=str(tmp_path), config=SMALL, width_scale=WS, updates={s: 2 for s in TASKS},
              joint_location=True, predict_radius=True, device="cpu", verbose=False, cache_frozen=True,
              compute_dtype="bfloat16")
    monkeypatch.setattr(Trainer, "__init__", recording)
    res = run_pipeline(3, train, val, **kw)
    monkeypatch.setattr(Trainer, "__init__", make)
    assert built == [(s, "bfloat16") for s in TASKS]
    capsys.readouterr()
    again = run_pipeline(3, train, val, resume=True, **kw)
    out = capsys.readouterr().out
    for s in TASKS:
        assert f"stage {s!r} complete in store" in out
        assert again[s][1] is None
        for k, v in res[s][0].items():
            assert v.dtype == torch.float32 and torch.equal(again[s][0][k], v), (s, k)


def test_cli_passes_compute_dtype_to_stages_and_evaluations(monkeypatch):
    """--compute-dtype bfloat16 reaches run_pipeline and both evaluation
    tasks; float32 is the default; another value is refused by the parser."""
    from acoustic_locating_vq_vae_torch import eval as teval
    from acoustic_locating_vq_vae_torch import train as ttrain
    from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli

    calls = {}
    monkeypatch.setattr(cli, "load_datasets", lambda args: (SMALL, "train", "val"))
    monkeypatch.setattr(ttrain, "run_pipeline", lambda *a, **kw: calls.setdefault("pipeline", kw) and {
        "location": ({}, None), "finetune": ({}, None), "location_joint": ({}, None)})
    monkeypatch.setattr(teval, "evaluate_location", lambda task, *a, **kw: calls.setdefault("location", task) and {})
    monkeypatch.setattr(teval, "evaluate_joint_location",
                        lambda task, *a, **kw: calls.setdefault("joint", task) and {})
    cli.main(["--compute-dtype", "bfloat16", "--joint-location", "--device", "cpu"])
    assert calls["pipeline"]["compute_dtype"] == "bfloat16"
    assert calls["location"].compute_dtype == "bfloat16" and calls["joint"].compute_dtype == "bfloat16"
    assert cli.build_parser().parse_args([]).compute_dtype == "float32"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--compute-dtype", "float16"])
