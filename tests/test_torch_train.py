"""The port's training slice against the JAX package on the CPU: latent
jitter, the speech and RIR VQ-VAE tasks (loss, metrics and every parameter
gradient, on the same weights carried across by ``params_from_jax``), the
EMA codebook update inside a task, one Adam step against ``optax.adam``, the
``Trainer`` loop and the dataset reader.

Widths are cut by ``width_scale = 1/32``; the speech stage runs 64 frames,
the RIR stage keeps its 500 frames as channels over the 201 bins. Inputs are
made with numpy. Convolution sums run in another order in XLA-CPU and
torch-CPU, so floats agree within rtol 1e-4 / atol 1e-5; codebooks are made
of pre-VQ latent rows, so no row sits on a near tie and the codes agree
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data.dataset import save_dataset
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_tpu.ops import jitter as jjitter
from acoustic_locating_vq_vae_tpu.train import RirVQVAETask as JaxRirVQVAETask
from acoustic_locating_vq_vae_tpu.train import SpeechVQVAETask as JaxSpeechVQVAETask
from acoustic_locating_vq_vae_torch.data import SampleBatch, SpecsDataset, sample_without_replacement
from acoustic_locating_vq_vae_torch.eval import params_from_jax
from acoustic_locating_vq_vae_torch.ops import Jitter, jitter
from acoustic_locating_vq_vae_torch.train import RirVQVAETask, SpeechVQVAETask, Trainer, TrainHistory

WS = 1 / 32
T_SPEECH = 64
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(b, t, seed):
    """A numpy sample batch: non-negative spectrograms, (B, 201, t)."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, 201, t)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(),
        fs=np.full((b,), 16000, np.int32), theta=rng.uniform(-3, 3, b).astype(np.float32),
        wiener_est=rng.exponential(1.0, (b, 201)).astype(np.float32), radius=np.ones(b, np.float32),
    )


def _jax_batch(d):
    return JaxSampleBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_batch(d):
    return SampleBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


# ---------------------------------------------------------------- jitter


def _jax_masks(key, p, shape):
    """The decisions ops/jitter.py:32-35 draws from ``key``."""
    k_replace, k_dir = jax.random.split(key)
    replace = jax.random.bernoulli(k_replace, p, shape)
    forward = jax.random.bernoulli(k_dir, 0.5, shape)
    return torch.from_numpy(np.array(replace)), torch.from_numpy(np.array(forward))


@pytest.mark.parametrize("per_batch", [False, True], ids=["shared", "per_batch"])
def test_jitter_matches_jax_with_its_masks(per_batch):
    """Same decisions -> same output; replaced slots carry no gradient."""
    b, d, length, p = 3, 5, 40, 0.4
    x = np.random.default_rng(0).standard_normal((b, d, length)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((b, d, length)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    xl = jnp.asarray(x.transpose(0, 2, 1))  # JAX jitters axis 1 of (B, L, D)
    f = lambda v: jnp.sum(jjitter(v, key, p, per_batch) * jnp.asarray(w.transpose(0, 2, 1)))
    want = np.asarray(jjitter(xl, key, p, per_batch)).transpose(0, 2, 1)
    want_grad = np.asarray(jax.grad(f)(xl)).transpose(0, 2, 1)

    replace, forward = _jax_masks(key, p, (b, length) if per_batch else (length,))
    xt = torch.from_numpy(x).requires_grad_()
    got = jitter(xt, replace, forward)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    assert bool(replace.any()) and bool((xt.grad == 0).any())


def test_jitter_statistics():
    """Replace rate ~ p, ends clamp to their single neighbour, decisions
    shared across the batch by default and per sample with ``per_batch``;
    a no-op off training or at p = 0."""
    b, length, p = 3, 20000, 0.25
    x = torch.arange(length, dtype=torch.float32).expand(b, 2, length).contiguous()
    out = Jitter(p)(x, generator=torch.Generator().manual_seed(0))
    src = out[:, 0, :].long()
    pos = torch.arange(length)
    assert bool(((src - pos).abs() <= 1).all())
    assert torch.equal(src[0], src[1]) and torch.equal(src[0], src[2])
    assert torch.equal(out[:, 0], out[:, 1])
    rate = float((src[0] != pos).float().mean())
    assert abs(rate - p) < 0.015, rate
    assert int(src[0, 0]) in (0, 1) and int(src[0, -1]) in (length - 1, length - 2)
    # every replaced end takes its only neighbour
    replace, forward = torch.ones(6, dtype=torch.bool), torch.tensor([False, True, False, True, False, True])
    ends = jitter(torch.arange(6.0)[None, None], replace, forward)[0, 0]
    assert ends.tolist() == [1, 2, 1, 4, 3, 4]

    per = Jitter(p, per_batch=True)(x, generator=torch.Generator().manual_seed(1))[:, 0, :].long()
    assert not torch.equal(per[0], per[1])
    assert abs(float((per != pos).float().mean()) - p) < 0.015
    assert Jitter(p)(x, train=False) is x and Jitter(0.0)(x) is x


def test_jitter_decisions_follow_the_generator():
    x = torch.randn(2, 3, 50)
    a = Jitter(0.3)(x, generator=torch.Generator().manual_seed(5))
    b = Jitter(0.3)(x, generator=torch.Generator().manual_seed(5))
    c = Jitter(0.3)(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------- tasks


def _latent_codebook_(model, x, seed):
    """K pre-VQ latent rows of ``x`` as the codebook (no near ties)."""
    with torch.no_grad():
        z = model.pre_vq_latent(x)
        rows = (z if model.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, model.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], model.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _task_pair(name, vq_ema=False):
    """(JAX task, its model, params, vq_stats or None, port task, port model)
    on the same weights, with a codebook of latent rows."""
    jcls, tcls, t, layers = {
        "speech": (JaxSpeechVQVAETask, SpeechVQVAETask, T_SPEECH, 3),
        "rir": (JaxRirVQVAETask, RirVQVAETask, 500, 2),
    }[name]
    jtask, task = jcls(width_scale=WS, vq_ema=vq_ema), tcls(width_scale=WS, vq_ema=vq_ema)
    jm = jtask.build_model()
    (x0,) = jtask.model_inputs(_jax_batch(_batch(1, t, 10)))
    variables = _np(jm.init({"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)}, x0))
    p, stats = variables["params"], variables.get("vq_stats")
    model = task.build_model()
    model.load_state_dict(params_from_jax(p, layers, vq_stats=stats))
    (x_seed,) = task.model_inputs(_torch_batch(_batch(2, t, 11)))
    cb = _latent_codebook_(model, x_seed, 12)
    if vq_ema:
        stats["_vq"]["codebook"] = cb
        stats["_vq"]["ema_sums"] = cb * 1.5
        stats["_vq"]["ema_counts"] = np.random.default_rng(13).uniform(0.5, 2.0, cb.shape[0]).astype(np.float32)
    else:
        p["_vq"]["codebook"] = cb
    model.load_state_dict(params_from_jax(p, layers, vq_stats=stats))
    return jtask, jm, p, stats, task, model, t, layers


@pytest.mark.parametrize("name", ["speech", "rir"])
def test_task_loss_and_every_gradient_match_jax(name):
    """Gradient mode, train=False (no jitter): loss, metrics and the gradient
    of every parameter, the codebook's included, key by key."""
    jtask, jm, p, _, task, model, t, layers = _task_pair(name)
    d = _batch(3, t, 20)

    def loss_fn(params):
        return jtask.loss(jm, params, _jax_batch(d), {}, False)

    (loss_j, metrics_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, p))
    want = params_from_jax(_np(grads_j), layers)

    loss, metrics = task.loss(model, _torch_batch(d), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    for k in ("recon_error", "vq_loss", "perplexity"):
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=RTOL, err_msg=k)
    names = dict(model.named_parameters())
    assert set(names) <= set(want) and "_vq._embedding.weight" in names
    for k, prm in names.items():
        np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def test_ema_task_step_matches_jax():
    """The RIR stage (no jitter) with an EMA codebook on a training step:
    loss, gradients and the updated codebook, counts and sums."""
    jtask, jm, p, stats, task, model, t, layers = _task_pair("rir", vq_ema=True)
    d = _batch(3, t, 21)

    def loss_fn(params):
        return jtask.loss(jm, params, _jax_batch(d), {}, True, variables={"vq_stats": stats})

    (loss_j, metrics_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, p))
    new_stats = _np(metrics_j["_variables"]["vq_stats"])
    assert "_vq" not in grads_j  # the EMA codebook is no parameter
    want = params_from_jax({**_np(grads_j), "_vq": {"codebook": np.zeros(1)}}, layers)

    model.train()
    loss, metrics = task.loss(model, _torch_batch(d), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    np.testing.assert_allclose(metrics["vq_loss"].item(), float(metrics_j["vq_loss"]), rtol=RTOL)
    for k, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    vq = model._vq
    np.testing.assert_allclose(vq.ema_counts.numpy(), new_stats["_vq"]["ema_counts"], rtol=1e-5)
    np.testing.assert_allclose(vq.ema_sums.numpy(), new_stats["_vq"]["ema_sums"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vq._embedding.weight.numpy(), new_stats["_vq"]["codebook"], rtol=RTOL, atol=ATOL)
    assert "_vq._embedding.weight" not in dict(model.named_parameters())

    # an eval step updates nothing
    before = vq._embedding.weight.clone()
    with torch.no_grad():
        task.loss(model, _torch_batch(d), False)
    assert torch.equal(before, vq._embedding.weight)


# ---------------------------------------------------------------- Adam, Trainer, data


def test_adam_step_matches_optax():
    """The trainer's optimizer from the same gradients gives optax.adam's
    parameters to rtol 1e-6, and atol 1e-7 (an ulp at |w| = 1) for entries
    that the step brings near zero."""
    rng = np.random.default_rng(30)
    w0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(3)]
    opt = optax.adam(1e-3)
    w_j = jnp.asarray(w0)
    state = opt.init(w_j)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, w_j)
        w_j = optax.apply_updates(w_j, upd)

    trainer = Trainer(SpeechVQVAETask(width_scale=WS), device="cpu", verbose=False)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = type(trainer.optimizer)([w], **{k: v for k, v in trainer.optimizer.defaults.items()})
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt_t.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-7)


def test_trainer_shares_tied_weights_and_seeds_alike():
    a = Trainer(SpeechVQVAETask(width_scale=WS), device="cpu", seed=3, verbose=False)
    b = Trainer(SpeechVQVAETask(width_scale=WS), device="cpu", seed=3, verbose=False)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    params = [p for g in a.optimizer.param_groups for p in g["params"]]
    assert len(params) == len({id(p) for p in params}) == len(list(a.model.parameters()))
    stack = a.model._decoder._residual_stack._layers
    assert stack[0] is stack[2]


@pytest.mark.parametrize("task_cls,ema", [(SpeechVQVAETask, False), (RirVQVAETask, False), (SpeechVQVAETask, True)],
                         ids=["speech", "rir", "speech_ema"])
def test_trainer_fit_on_cpu(task_cls, ema, tmp_path, capsys):
    """A few steps with an eval step in their place: finite, falling loss,
    one val entry, a frames/s log line, and the history's .npz round trip."""
    task = task_cls(width_scale=WS, batch_size=4, eval_every=4, vq_ema=ema)
    t = T_SPEECH if task.name == "speech" else 500
    train, val = _torch_batch(_batch(8, t, 40)), _torch_batch(_batch(4, t, 41))
    trainer = Trainer(task, device="cpu", seed=0, log_every=4)
    history = trainer.fit(train, val, num_updates=8)
    loss = history.finalize()["train"]["loss"]
    assert loss.shape == (6,) and np.isfinite(loss).all() and loss[-1] < loss[0]
    assert history.finalize()["val"]["loss"].shape == (2,)
    assert "frames/s" in capsys.readouterr().out
    path = tmp_path / "history.npz"
    history.save(str(path))
    back = TrainHistory.load(str(path))
    np.testing.assert_array_equal(back["train"]["loss"], loss)


def test_sample_casts_bf16_and_draws_distinct_rows():
    trainer = Trainer(SpeechVQVAETask(width_scale=WS, batch_size=5), device="cpu", verbose=False)
    data = _torch_batch(_batch(9, 8, 50))
    data = data._replace(speech_spec=data.speech_spec.to(torch.bfloat16))
    batch = trainer.sample(data)
    assert batch.speech_spec.dtype == torch.float32 and batch.speech_spec.shape == (5, 201, 8)
    idx = sample_without_replacement(torch.Generator().manual_seed(0), 9, 9)
    assert sorted(idx.tolist()) == list(range(9))
    with pytest.raises(ValueError, match="cannot sample"):
        sample_without_replacement(torch.Generator(), 3, 4)


def test_specs_dataset_reads_jax_save_dataset(tmp_path):
    d = _batch(3, 12, 60)
    d["speech_spec"] = d["speech_spec"][:, :, :12]
    save_dataset(str(tmp_path), _jax_batch(d), JaxDatasetConfig(num_frames=10))
    ds = SpecsDataset(str(tmp_path))
    assert len(ds) == 3 and ds.config.num_frames == 10
    got = ds.load_all()
    assert got.speech_spec.shape == (3, 201, 10)
    np.testing.assert_array_equal(got.speech_spec.numpy(), d["speech_spec"][:, :, :10])
    np.testing.assert_array_equal(got.rir_spec.numpy(), d["rir_spec"][:, :, :10])
    np.testing.assert_array_equal(got.wiener_est.numpy(), d["wiener_est"])
    np.testing.assert_array_equal(got.theta.numpy(), d["theta"])
    np.testing.assert_array_equal(got.fs.numpy(), d["fs"])
    with pytest.raises(ValueError, match="fewer than"):
        ds.load_all(num_frames=13)
