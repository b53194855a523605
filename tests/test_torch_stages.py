"""The port's composite and location stages against the JAX package on the
CPU: the echoed-speech composite (forward, loss and every gradient, frozen,
with ``train_encoder`` and with a commitment anchor), its frozen-latent cache,
the stage handoff (``graft_pretrained``, ``check_flatten_handoff``), the frozen
and the joint location stages, ``make_task`` and the ``Trainer`` on all four.

Weights are drawn by the JAX package and carried across by
``composite_params_from_jax`` / ``params_from_jax``; each codebook is made of
pre-VQ latent rows, so no row sits on a near tie and the codes agree exactly.
Widths are cut by ``width_scale = 1/32`` and the geometry to 33 bins x 64
frames. Convolution sums run in another order in XLA-CPU and torch-CPU, so
floats agree within rtol 1e-4 / atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_tpu.eval.torch_export import echoed_state_dict
from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax, params_from_jax
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask,
    EncoderFinetuneTask,
    JointLocationTask,
    LocationTask,
    Trainer,
    check_flatten_handoff,
    graft_pretrained,
    make_task,
)

GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames  # 33 bins, 64 frames
WS = 1 / 32
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(b, seed):
    """A numpy sample batch: non-negative spectrograms (B, F, T), angles and
    radii."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, F, T)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full((b,), 16000, np.int32),
        theta=rng.uniform(-3, 3, b).astype(np.float32), wiener_est=rng.exponential(1.0, (b, F)).astype(np.float32),
        radius=rng.uniform(0.5, 1.5, b).astype(np.float32),
    )


def _jax_batch(d):
    return JaxSampleBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_batch(d):
    return SampleBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _latent_rows(branch, x, seed):
    """K pre-VQ latent rows of ``x`` as the branch's quantizer sees them."""
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _init(model, *inputs, seed=0):
    return _np(model.init({"params": jax.random.PRNGKey(seed), "jitter": jax.random.PRNGKey(seed + 1)}, *inputs)["params"])


_COMPOSITES = {}


def _composite(flatten: bool):
    """A JAX composite grafted from freshly initialised speech and RIR
    stages, its codebooks made of latent rows: (JAX task, model, params,
    port task, port model on the same weights)."""
    if flatten not in _COMPOSITES:
        kw = dict(config=JSMALL, width_scale=WS, compat_vq_flatten=flatten)
        jtask = jtrain.EchoedSpeechTask(**kw)
        jm = jtask.build_model()
        x, x_rir = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
        speech_p = _init(jtrain.SpeechVQVAETask(**kw).build_model(), x, seed=2)
        rir_p = _init(jtrain.RirVQVAETask(**kw).build_model(), x_rir, seed=4)
        p = _np(jtrain.graft_pretrained(_init(jm, x, x_rir), speech_p, rir_p))
        task = EchoedSpeechTask(config=SMALL, width_scale=WS, compat_vq_flatten=flatten)
        model = task.build_model()
        model.load_state_dict(composite_params_from_jax(p))
        xs, xr = task.model_inputs(_torch_batch(_batch(2, 10)))
        p["speech_model"]["_vq"]["codebook"] = _latent_rows(model.speech_model, xs, 11)
        p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, xr, 12)
        _COMPOSITES[flatten] = (jtask, jm, p)
    jtask, jm, p = _COMPOSITES[flatten]
    task = EchoedSpeechTask(config=SMALL, width_scale=WS, compat_vq_flatten=flatten)
    model = task.build_model()
    model.load_state_dict(composite_params_from_jax(p))  # strict: the grafted keys are the port's
    return jtask, jm, p, task, model


def _as_jax(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


# ---------------------------------------------------------------- the composite


@pytest.mark.parametrize("flatten", [True, False], ids=["compat", "vectors"])
def test_composite_forward_matches_jax(flatten):
    """train=False: the recon, both perplexities and both branch VQ losses."""
    _, jm, p, task, model = _composite(flatten)
    d = _batch(3, 20)
    x, x_rir = task.model_inputs(_torch_batch(d))
    want = jm.apply({"params": _as_jax(p)}, jnp.asarray(x.numpy()), jnp.asarray(x_rir.numpy()), train=False,
                    return_vq_losses=True)
    with torch.no_grad():
        got = model(x, x_rir, train=False, return_vq_losses=True)
    assert got[0].shape == (3, F, T)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=RTOL)
    for k in ("speech", "rir"):
        np.testing.assert_allclose(got[3][k].item(), float(want[3][k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize(
    "train_encoder,commitment_weight", [(False, 0.0), (True, 0.0), (False, 0.25)],
    ids=["frozen", "train_encoder", "anchored"],
)
def test_echoed_loss_and_every_gradient_match_jax(train_encoder, commitment_weight):
    """Loss, metrics and the gradient of every parameter. A parameter the
    port leaves without a gradient (frozen codebooks, never-run branch
    decoders, frozen encoders) has an exactly zero gradient in JAX."""
    jtask, jm, p, task, model = _composite(True)
    jtask = dataclasses.replace(jtask, train_encoder=train_encoder, commitment_weight=commitment_weight)
    task = dataclasses.replace(task, train_encoder=train_encoder, commitment_weight=commitment_weight)
    d = _batch(3, 21)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda params: jtask.loss(jm, params, _jax_batch(d), {}, False), has_aux=True
    )(_as_jax(p))
    want = composite_params_from_jax(_np(grads_j))

    loss, metrics = task.loss(model, _torch_batch(d), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    assert set(metrics) == set(metrics_j)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=RTOL, err_msg=k)
    trained = set()
    for k, prm in model.named_parameters():
        if prm.grad is None:
            assert not want[k].any(), f"{k}: no gradient in the port, a nonzero one in JAX"
        else:
            np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
            trained.add(k.split(".")[0])
    assert model.speech_model._vq._embedding.weight.grad is None and model.rir_model._vq._embedding.weight.grad is None
    # the decoder always learns; the encoders only through the latent or the anchor
    assert trained == ({"_decoder", "speech_model", "rir_model"} if train_encoder or commitment_weight else {"_decoder"})
    enc = model.speech_model._encoder._conv_1.weight.grad
    assert (enc is None) == (not train_encoder and not commitment_weight)


@pytest.mark.parametrize("flatten", [True, False], ids=["compat", "vectors"])
def test_codes_and_cached_loss_match(flatten):
    """``encode_codes`` equals JAX's; ``codes_to_latent`` of the codes is the
    branch's quantized latent; ``loss_cached`` equals ``loss`` on the same
    weights and batch to rtol 1e-6 (the straight-through value's last bit)."""
    _, jm, p, task, model = _composite(flatten)
    d = _batch(3, 22)
    batch = _torch_batch(d)
    x, x_rir = task.model_inputs(batch)
    want = jm.apply({"params": _as_jax(p)}, jnp.asarray(x.numpy()), jnp.asarray(x_rir.numpy()),
                    method=jm.encode_codes)
    cache = task.build_cache(model, batch)
    for k in ("speech_codes", "rir_codes"):
        assert cache[k].dtype == torch.int32
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(want[k]), err_msg=k)
    with torch.no_grad():
        for branch, inp, codes in ((model.speech_model, x, cache["speech_codes"]),
                                   (model.rir_model, x_rir, cache["rir_codes"])):
            _, q, _, _ = branch.get_latent_representation(inp, need_encodings=False)
            np.testing.assert_allclose(branch.codes_to_latent(codes).numpy(), q.numpy(), rtol=1e-6, atol=1e-6)
        for train in (False, True):
            uncached = task.loss(model, batch, train, torch.Generator().manual_seed(3))
            cached = task.loss_cached(model, batch, cache, train, torch.Generator().manual_seed(3))
            np.testing.assert_allclose(cached[0].item(), uncached[0].item(), rtol=1e-6)
            for k, v in uncached[1].items():
                np.testing.assert_allclose(cached[1][k].item(), v.item(), rtol=1e-6, err_msg=k)


def test_supports_cache_rules():
    kw = dict(config=SMALL, width_scale=WS)
    assert EchoedSpeechTask(**kw).supports_cache
    assert not EncoderFinetuneTask(**kw).supports_cache
    assert not EchoedSpeechTask(commitment_weight=0.25, **kw).supports_cache
    assert LocationTask(**kw).supports_cache
    assert not JointLocationTask(**kw).supports_cache
    assert EchoedSpeechTask(**kw).cached_frozen_subtrees == ("rir_model", "speech_model")
    with pytest.raises(ValueError, match="no frozen path"):
        Trainer(EncoderFinetuneTask(**kw), device="cpu", verbose=False).build_cache(_torch_batch(_batch(2, 0)))


def _branch_weights(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.startswith(("rir_model.", "speech_model."))}


def test_cached_trainer_run_matches_uncached():
    """20 steps from one seed, an eval step every 10th, cached against
    uncached: metrics within the JAX test's rtol 3e-3 / atol 1e-5 and decoder
    weights within rtol 1e-2 / atol 2e-4 (the straight-through value's last
    bit drifts through Adam); the branches bitwise as they started."""
    _, _, p, _, _ = _composite(True)
    task = EchoedSpeechTask(config=SMALL, width_scale=WS, batch_size=4, eval_every=10)
    train, val = _torch_batch(_batch(10, 30)), _torch_batch(_batch(6, 31))
    runs = {}
    for cached in (False, True):
        tr = Trainer(task, device="cpu", seed=5, verbose=False, cache_frozen=cached)
        tr.model.load_state_dict(composite_params_from_jax(p))
        before = _branch_weights(tr.model)
        runs[cached] = tr.fit(train, val, num_updates=20).finalize(), tr.model
        for k, v in _branch_weights(tr.model).items():
            assert torch.equal(v, before[k]), k
    (ref, ref_model), (got, got_model) = runs[False], runs[True]
    for split in ("train", "val"):
        assert set(got[split]) == set(ref[split])
        for k in ref[split]:
            np.testing.assert_allclose(got[split][k], ref[split][k], rtol=3e-3, atol=1e-5, err_msg=f"{split}/{k}")
    for k, v in ref_model._decoder.state_dict().items():
        np.testing.assert_allclose(got_model._decoder.state_dict()[k].numpy(), v.numpy(), rtol=1e-2, atol=2e-4,
                                   err_msg=k)


# ---------------------------------------------------------------- the handoff


def test_graft_pretrained_matches_jax():
    """The JAX graft (the RIR donor with an EMA codebook) against the port's
    on state dicts: the keys are ``echoed_state_dict``'s, the values equal,
    the EMA statistics dropped, the tensors copies, and the result loads
    strictly into the port's composite."""
    kw = dict(config=JSMALL, width_scale=WS)
    x, x_rir = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
    comp = _init(jtrain.EchoedSpeechTask(**kw).build_model(), x, x_rir)
    speech_p = _init(jtrain.SpeechVQVAETask(**kw).build_model(), x, seed=6)
    rir_vars = _np(jtrain.RirVQVAETask(vq_ema=True, **kw).build_model().init(jax.random.PRNGKey(8), x_rir))
    rir_vars["vq_stats"]["_vq"]["codebook"] = rir_vars["vq_stats"]["_vq"]["codebook"] + 0.5  # not the init's
    want_tree = jtrain.graft_pretrained(comp, speech_p, rir_vars["params"], rir_variables=rir_vars)
    want = echoed_state_dict(_np(want_tree), 2, 3, 2)

    fresh = {k: v for k, v in composite_params_from_jax(comp).items()}
    speech = params_from_jax(speech_p, 3)
    rir = params_from_jax(rir_vars["params"], 2, vq_stats=rir_vars["vq_stats"])
    assert "_vq.ema_counts" in rir and "_vq.ema_sums" in rir
    got = graft_pretrained(fresh, speech, rir)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert got["speech_model._encoder._conv_1.weight"].data_ptr() != speech["_encoder._conv_1.weight"].data_ptr()
    model = EchoedSpeechTask(config=SMALL, width_scale=WS).build_model()
    model.load_state_dict(got)
    assert isinstance(model.rir_model._vq._embedding.weight, torch.nn.Parameter)


def test_check_flatten_handoff_refuses_a_mismatch():
    task = EchoedSpeechTask(config=SMALL, width_scale=WS)  # resolves to compat
    check_flatten_handoff({"compat_vq_flatten": True}, task, "speech")
    check_flatten_handoff({}, task, "speech")  # no metadata: not checked
    with pytest.raises(ValueError, match="VQ flatten mismatch"):
        check_flatten_handoff({"compat_vq_flatten": False}, task, "speech")
    with pytest.raises(ValueError, match="VQ flatten mismatch"):
        check_flatten_handoff({"compat_vq_flatten": True}, JointLocationTask(), "echoed")
    with pytest.raises(ValueError, match="VQ flatten mismatch") as err_port:
        check_flatten_handoff({"compat_vq_flatten": False}, task, "speech")
    with pytest.raises(ValueError, match="VQ flatten mismatch") as err_jax:
        jtrain.tasks.check_flatten_handoff({"compat_vq_flatten": False}, jtrain.EchoedSpeechTask(), "speech")
    assert str(err_port.value).split(". Build")[0] == str(err_jax.value).split(". Re-run")[0]


# ---------------------------------------------------------------- location


@pytest.mark.parametrize("input_mode", ["encodings", "quantized"])
@pytest.mark.parametrize("target_mode", ["normalized_angle", "sincos"])
def test_location_loss_matches_jax(input_mode, target_mode):
    """The frozen stage: features of the composite's RIR branch, the head's
    loss and every head gradient; the cached features equal the uncached."""
    _, _, comp_p, _, composite = _composite(True)
    kw = dict(width_scale=WS, input_mode=input_mode, target_mode=target_mode)
    jtask = jtrain.LocationTask(config=JSMALL, **kw)
    jcomp, jhead = jtask.build_composite(), jtask.build_model()
    width = 32 if input_mode == "encodings" else 4  # K or D of the RIR branch
    head_p = _init(jhead, jnp.zeros((1, F, width)), seed=9)
    d = _batch(4, 40)
    enc_j = jtask.encodings_from_composite(jcomp, _as_jax(comp_p), _jax_batch(d))
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda params: jtask.loss(jhead, params, _jax_batch(d), {}, True, encodings=enc_j), has_aux=True
    )(_as_jax(head_p))

    task = LocationTask(config=SMALL, **kw)
    head = task.build_model()
    head.load_state_dict(params_from_jax(head_p))
    batch = _torch_batch(d)
    feats = task.encodings_from_composite(composite.rir_model, batch.echoed_spec)
    np.testing.assert_allclose(feats.numpy(), np.asarray(enc_j), rtol=RTOL, atol=ATOL)
    cached = task.feats_from_codes(composite.rir_model, task.build_cache(composite.rir_model, batch))
    np.testing.assert_allclose(cached.numpy(), feats.numpy(), rtol=1e-6, atol=1e-6)
    loss, metrics = task.loss(head, batch, True, feats=feats)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(metrics["location_error"].item(), float(metrics_j["location_error"]), rtol=RTOL)
    want = params_from_jax(_np(grads_j))
    for k, prm in head.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    with pytest.raises(ValueError, match="feats"):
        task.loss(head, batch, True)


def _joint_pair(**kw):
    jtask = jtrain.JointLocationTask(config=JSMALL, width_scale=WS, **kw)
    jm = jtask.build_model()
    p = _init(jm, jnp.zeros((1, T, F)), seed=12)
    task = JointLocationTask(config=SMALL, width_scale=WS, **kw)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    (x,) = task.model_inputs(_torch_batch(_batch(2, 13)).echoed_spec)
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, x, 14)
    model.load_state_dict(params_from_jax(p))
    return jtask, jm, p, task, model


def _jax_value_and_grad(jtask, jm, p, d, dtype):
    cast = lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype == np.float32 else jnp.asarray(a)
    batch = JaxSampleBatch(**{k: cast(v) for k, v in d.items()})
    return jax.value_and_grad(lambda params: jtask.loss(jm, params, batch, {}, True), has_aux=True)(
        jax.tree_util.tree_map(cast, p))


@pytest.mark.parametrize(
    "kw", [dict(predict_radius=True, tail_weight=0.5), dict(target_mode="normalized_angle")],
    ids=["sincos_radius_tail", "angle"],
)
def test_joint_loss_and_every_gradient_match_jax(kw):
    """The joint stage: loss, metrics (tail and radius terms included) and
    every gradient against the same step of JAX in float64; the frozen
    codebook has no gradient, zero in JAX. JAX's own float32 gradient of the
    RIR encoder lies up to 3 % of its max from float64 here (XLA-CPU), the
    port's within 1e-6."""
    jtask, jm, p, task, model = _joint_pair(**kw)
    d = _batch(8, 50)  # tail over ceil(8 / 8) = 1 sample
    with jax.enable_x64(True):
        (loss_j, metrics_j), grads_j = _jax_value_and_grad(jtask, jm, p, d, jnp.float64)
        want = params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads_j))
    loss, metrics = task.loss(model, _torch_batch(d), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    assert set(metrics) == set(metrics_j)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=RTOL, err_msg=k)
    for k, prm in model.named_parameters():
        if prm.grad is None:
            assert k == "rir_model._vq._embedding.weight" and not want[k].any(), k
        else:
            np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def test_joint_seed_params_matches_jax():
    """The joint model's RIR branch from a composite, as JAX's seed_params;
    the composite branch's decoder, which the joint model lacks, is left."""
    _, _, comp_p, _, composite = _composite(True)
    jtask, _, p, task, model = _joint_pair()
    want = params_from_jax(_np(jtask.seed_params(p, comp_p)))
    got = task.seed_params(model.state_dict(), composite.state_dict())
    assert set(got) == set(model.state_dict()) and set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert got["rir_model._encoder._conv_1.weight"].data_ptr() != composite.rir_model._encoder._conv_1.weight.data_ptr()
    model.load_state_dict(got)


# ---------------------------------------------------------------- tasks and the trainer


def test_make_task_matches_jax():
    for name in ("speech", "rir", "echoed", "finetune", "location", "location_joint"):
        task, jtask = make_task(name, width_scale=WS), jtrain.make_task(name, width_scale=WS)
        assert type(task).__name__ == type(jtask).__name__
        for f in ("name", "learning_rate", "batch_size", "num_updates", "eval_every"):
            assert getattr(task, f) == getattr(jtask, f), (name, f)
        assert task.resident_fields == jtask.resident_fields, name
        assert getattr(task, "supports_cache") == getattr(jtask, "supports_cache"), name
    assert make_task("finetune").train_encoder and make_task("finetune").learning_rate == 1e-5
    joint = make_task("location_joint", predict_radius=True)
    assert (joint.commitment_weight, joint.target_mode, joint.compat_vq_flatten) == (0.25, "sincos", False)


def test_location_trainer_needs_composite_params():
    with pytest.raises(ValueError, match="composite_params"):
        Trainer(LocationTask(config=SMALL, width_scale=WS), device="cpu", verbose=False)


def test_location_trainer_holds_the_rir_branch_only():
    """The location trainer keeps the composite's RIR branch without its
    decoder, as copies, in eval mode and without gradients; a composite
    missing a key of that branch is refused."""
    task = LocationTask(config=SMALL, width_scale=WS)
    comp = task.build_composite(torch.Generator().manual_seed(3)).state_dict()
    tr = Trainer(task, device="cpu", verbose=False, composite_params=comp)
    want = {k[len("rir_model."):]: v for k, v in comp.items()
            if k.startswith("rir_model.") and not k.startswith("rir_model._decoder.")}
    got = tr.frozen_rir.state_dict()
    assert set(got) == set(want) and set(got) == set(task.build_rir_model().state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v) and got[k].data_ptr() != v.data_ptr(), k
    assert not tr.frozen_rir.training
    assert not any(p.requires_grad for p in tr.frozen_rir.parameters())
    assert not {id(p) for p in tr.frozen_rir.parameters()} & {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    with pytest.raises(RuntimeError, match="Missing key"):
        Trainer(task, device="cpu", verbose=False,
                composite_params={k: v for k, v in comp.items() if k != "rir_model._vq._embedding.weight"})


@pytest.mark.parametrize("task_cls", [EchoedSpeechTask, EncoderFinetuneTask, LocationTask, JointLocationTask],
                         ids=["echoed", "finetune", "location", "location_joint"])
def test_new_stage_trainer_without_a_card_raises(task_cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(task_cls(config=SMALL, width_scale=WS), composite_params={})


@pytest.mark.parametrize("name,cached", [("echoed", True), ("finetune", False), ("location", True),
                                         ("location_joint", False)])
def test_trainer_fit_on_cpu(name, cached, capsys):
    """A few steps of each stage, chained in memory from one composite: an
    eval step in the place of every 4th, finite metrics, a log line; the
    cache refuses a dataset pruned of the field the task reads."""
    _, _, comp_p, _, composite = _composite(True)
    comp = composite.state_dict()
    kw = dict(config=SMALL, width_scale=WS, batch_size=4, eval_every=4)
    task = make_task(name, **kw)
    tr = Trainer(task, device="cpu", seed=1, log_every=4, cache_frozen=cached,
                 composite_params=comp if name == "location" else None)
    if name in ("echoed", "finetune"):
        tr.model.load_state_dict(comp)
    elif name == "location_joint":
        tr.model.load_state_dict(task.seed_params(tr.model.state_dict(), comp))
    train, val = _torch_batch(_batch(8, 60)), _torch_batch(_batch(4, 61))
    history = tr.fit(train, val, num_updates=8).finalize()
    assert history["train"]["loss"].shape == (6,) and history["val"]["loss"].shape == (2,)
    assert all(np.isfinite(v).all() for split in history.values() for v in split.values())
    assert "frames/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="pruned"):
        tr.fit(train._replace(echoed_spec=train.echoed_spec[:, :0]), num_updates=1)
