"""The port's data parallelism on the CPU: two gloo ranks against the port's
single-process step and against the JAX package's ``Trainer`` on
``make_mesh(data=2)``.

One spawn per module: the fixture starts two worker processes (this file run
as a script, ranks 0 and 1 over gloo on localhost), which run every
data-parallel check and save what they saw; while they run, the parent
computes the single-process port steps and the JAX mesh steps on the same
seeded weights of the JAX models' shapes (carried across by ``params_from_jax``) and the same global batch.
The JAX trainer's sampling is bypassed (its per-shard draw takes the shard's
rows in order, so the global batch is the given one), and both packages
replay the same fixed jitter decisions (Philox cannot replay threefry), so a
train step is compared with jitter on.

Widths are cut by ``width_scale = 1/32``; the speech stage runs 201 bins x
32 frames, the echoed stage 33 bins x 64 frames. Tolerances: the 2-rank step
against the single-process one within rtol 1e-5 (the sums run in another
order); against JAX rtol 1e-4 / atol 1e-5, as the other parity tests; the
EMA counts and the perplexity exactly; the ranks' codebooks bitwise.

Since the model and sequence axes were ported, the same spawn also holds the
data-parallel paths that had no test: the on-the-fly bank-then-exact joint
recipe (its ranks' weights bitwise equal, a preempted recipe resumed bitwise
at the same world size) and a bf16 step, held to the single-process bf16 step
by ``test_torch_bf16.py``'s criterion (the two-rank step within half of the
single process's bf16 distance from its float32 step). The spawn also fits
over a host-staged set, each rank holding its block of every chunk, against
the single process's host-staged fit.

The workers import torch and the port only (this module imports JAX inside
its fixtures)."""

import importlib
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.parallel import (
    DataParallel,
    init_data_parallel,
    local_mesh,
    rank_seed,
    replicate,
    shard_batch,
)
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, JointLocationTask, SpeechVQVAETask, Trainer

WS = 1 / 32
WORLD = 2
B = 4  # the global batch, 2 rows a rank
T_SPEECH = 32
ECHOED = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)  # 33 bins x 64 frames
ECHOED_CFG = DatasetConfig(**ECHOED)
OTF_CFG = DatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)  # the smoke geometry
OTF_CHUNK = 2048
HALF, F32_REL = 0.5, 1e-5  # test_torch_bf16.py's criterion
BF16_UNIT = 2.0 ** -8  # bf16's unit roundoff: one rounding of a rank's share of a gradient
RESEED = 5.0  # an EMA reset threshold every code falls below: every code restarts from a global row
JITTER_SEED = 900
DP_RTOL = 1e-5
# a gradient entry summed from terms of both signs keeps the float32 rounding of its largest terms: up to
# about 1e3 terms x 6e-8 of the gradient's largest entry, in another order on the ranks than in one process
GRAD_ATOL_SHARE = 1e-4
RTOL, ATOL = 1e-4, 1e-5
STEPS = 2
LR = SpeechVQVAETask.learning_rate


# ---------------------------------------------------------------- shared helpers (parent and workers)


def _masks(length: int, probability: float):
    """The fixed jitter decisions both packages replay, (length,) bool."""
    rng = np.random.default_rng(JITTER_SEED + length)
    return rng.random(length) < probability, rng.random(length) < 0.5


def _fixed_decisions(shape, probability, generator=None):
    """Stands in for the port's ``ops.jitter.jitter_decisions``."""
    replace, forward = _masks(shape[-1], probability)
    return torch.from_numpy(np.broadcast_to(replace, shape).copy()), torch.from_numpy(np.broadcast_to(forward, shape).copy())


def _jitter_module(package: str):
    """The jitter module itself (the ops packages export a function of its name)."""
    return importlib.import_module(f"{package}.ops.jitter")


def _patch_port_jitter():
    _jitter_module("acoustic_locating_vq_vae_torch").jitter_decisions = _fixed_decisions


def _batch(b, f, t, seed):
    """A numpy sample batch: non-negative spectrograms (b, f, t)."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, f, t)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full((b,), 16000, np.int32),
        theta=rng.uniform(-3, 3, b).astype(np.float32), wiener_est=rng.exponential(1.0, (b, f)).astype(np.float32),
        radius=rng.uniform(0.5, 1.5, b).astype(np.float32),
    )


def _torch_batch(d):
    return SampleBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _speech_task(ema=False, batch_size=B):
    return SpeechVQVAETask(width_scale=WS, batch_size=batch_size, vq_ema=ema)


def _echoed_task():
    return EchoedSpeechTask(config=ECHOED_CFG, width_scale=WS, batch_size=B)


def _trainer(task, weights, dp=None, reseed=False, **kw):
    tr = Trainer(task, device="cpu", seed=0, verbose=False, mesh=dp, **kw)
    tr.model.load_state_dict(weights)
    if reseed:
        tr.model._vq.ema_reset_threshold = RESEED
    return tr


def _one_step(tr, batch):
    """One train step's metrics and gradients."""
    metrics = {k: v.clone() for k, v in tr.step(batch).items()}
    return {"metrics": metrics,
            "grads": {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}}


def _recipe(root, store, inputs, dp=None, **kw):
    """The joint stage's bank-then-exact recipe on the fly: 2 updates from
    the RIR bank, 2 with exact synthesis."""
    from acoustic_locating_vq_vae_torch.train import fit_joint_recipe

    task = JointLocationTask(config=OTF_CFG, width_scale=WS, batch_size=8, predict_radius=True)
    return fit_joint_recipe(task, 41, None, inputs["otf_val"], str(root / store), inputs["otf_composite"], 2, 4,
                            exact_synth_kwargs=dict(rir_chunk=OTF_CHUNK), verbose=False, on_the_fly=True,
                            device="cpu", synth_kwargs=dict(rir_bank=inputs["otf_bank"], rir_chunk=OTF_CHUNK),
                            mesh=dp, **kw)[0]


def _host_fit(rows, dp=None):
    """5 steps over a host-staged set of 12 rows in chunks of B, rotated
    every 2 steps: the losses and the weights."""
    from acoustic_locating_vq_vae_torch.data import HostStagedDataset

    tr = Trainer(_speech_task(), device="cpu", seed=5, verbose=False, mesh=dp)
    history = tr.fit(HostStagedDataset(_torch_batch(rows), B, rotate_every=2), num_updates=5)
    return {"loss": [float(v) for v in history.train["loss"]], "state": tr.model.state_dict()}


def _run_steps(tr, batch, cached=False):
    """STEPS train steps on ``batch``; the metrics of each, the state dict
    and the gradients after them."""
    cache = tr.build_cache(batch) if cached else None
    metrics = [{k: v.clone() for k, v in tr.step(batch, cache=cache).items()} for _ in range(STEPS)]
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
    return {"metrics": metrics, "state": {k: v.clone() for k, v in tr.model.state_dict().items()}, "grads": grads}


# ---------------------------------------------------------------- the worker


def _worker(rank: int, port: int, root: Path) -> None:
    import torch.distributed as dist

    from acoustic_locating_vq_vae_torch.train import Preempted, run_pipeline

    torch.set_num_threads(2)
    _patch_port_jitter()
    dp = init_data_parallel(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    out = {}

    # the steps on a given global batch, each rank its block
    speech = _torch_batch(inputs["speech_batch"])
    out["speech"] = _run_steps(_trainer(_speech_task(), inputs["speech"], dp), shard_batch(speech, dp))
    odd = _torch_batch(inputs["odd_batch"])  # 3 rows: blocks of 2 and 1
    out["odd"] = _run_steps(_trainer(_speech_task(batch_size=3), inputs["speech"], dp), shard_batch(odd, dp))
    out["ema"] = _run_steps(_trainer(_speech_task(ema=True), inputs["ema"], dp, reseed=True), shard_batch(speech, dp))
    echoed = _torch_batch(inputs["echoed_batch"])
    out["echoed"] = _run_steps(_trainer(_echoed_task(), inputs["echoed"], dp), shard_batch(echoed, dp))
    out["echoed_cached"] = _run_steps(_trainer(_echoed_task(), inputs["echoed"], dp), shard_batch(echoed, dp),
                                      cached=True)

    # stratified sampling: rows identified by their theta
    rows = _torch_batch(_batch(12, 201, 8, 5))._replace(theta=torch.arange(12.0))
    tr = _trainer(_speech_task(), inputs["speech"], dp)
    held = tr.hold(rows)
    out["block"] = held.theta.tolist()
    out["draws"] = [held.theta[tr._held_indices(12, "cpu")].tolist() for _ in range(3)]
    out["sample"] = tr.sample(rows).theta.tolist()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        odd_rows = rows.map(lambda a: a[:7])
        held = tr.hold(odd_rows)
    out["odd_warned"] = [str(w.message) for w in caught]
    out["odd_held"] = held.theta.tolist()
    out["odd_draw"] = held.theta[tr._held_indices(7, "cpu")].tolist()

    # the weights must start equal on every rank; replicate makes them so
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    out["replicated"] = {k: v.clone() for k, v in replicate(lin, dp).state_dict().items()}
    try:
        Trainer(_speech_task(), device="cpu", seed=rank, verbose=False, mesh=dp)
        out["replica_error"] = None
    except RuntimeError as e:
        out["replica_error"] = str(e)

    # a fit preempted on rank 1 alone, resumed: bitwise the uninterrupted fit
    train, val = _torch_batch(_batch(8, 201, 8, 6)), _torch_batch(_batch(4, 201, 8, 7))
    fit_task = SpeechVQVAETask(width_scale=WS, batch_size=4, eval_every=3, ckpt_every=2, num_updates=5)
    whole = Trainer(fit_task, device="cpu", seed=3, verbose=False, mesh=dp,
                    checkpoint_dir=str(root / "fit_whole"))
    whole.fit(train, val)
    cut = Trainer(fit_task, device="cpu", seed=3, verbose=False, mesh=dp,
                  checkpoint_dir=str(root / "fit_cut"))
    if rank == 1:
        step = cut.step

        def step_then_preempt(*args, **kwargs):
            m = step(*args, **kwargs)
            if cut.step_count == 3:
                cut.request_preemption()
            return m

        cut.step = step_then_preempt
    try:
        cut.fit(train, val)
        out["preempted_at"] = None
    except Preempted as e:
        out["preempted_at"] = e.completed
    resumed = Trainer(fit_task, device="cpu", seed=3, verbose=False, mesh=dp,
                      checkpoint_dir=str(root / "fit_cut"))
    resumed.fit(train, val, resume=True)
    out["resumed_at"] = resumed.step_count
    out["fit_bitwise"] = all(torch.equal(a, b) for a, b in zip(whole.model.state_dict().values(),
                                                               resumed.model.state_dict().values()))
    out["fit_state"] = whole.model.state_dict()

    # a host-staged fit: each rank holds its block of every chunk (the batch is the chunk)
    out["host"] = _host_fit(inputs["host_rows"], dp)

    # a bf16 step
    out["bf16"] = _one_step(_trainer(SpeechVQVAETask(width_scale=WS, batch_size=B, compute_dtype="bfloat16"),
                                     inputs["speech"], dp), shard_batch(speech, dp))

    # the on-the-fly bank->exact joint recipe, whole, and preempted on rank 1 in the polish leg then resumed
    out["otf_state"] = _recipe(root, "otf_whole", inputs, dp).model.state_dict()
    step, calls = Trainer.step, [0]

    def stepping(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 3 and rank == 1:
            self.request_preemption()
        return step(self, *args, **kwargs)

    Trainer.step = stepping
    try:
        _recipe(root, "otf_cut", inputs, dp)
        out["otf_preempted_at"] = None
    except Preempted as e:
        out["otf_preempted_at"] = e.completed
    finally:
        Trainer.step = step
    resumed = _recipe(root, "otf_cut", inputs, dp, resume=True)
    out["otf_resumed"] = resumed.model.state_dict()
    out["otf_resumed_at"] = resumed.step_count

    # the pipeline: every stage data-parallel, rank 0 writes the store
    cfg = ECHOED_CFG
    ptrain, pval = _torch_batch(_batch(8, cfg.num_freq, cfg.num_frames, 8)), _torch_batch(
        _batch(4, cfg.num_freq, cfg.num_frames, 9))
    res = run_pipeline(1, ptrain, pval, store_dir=str(root / "pipeline"), config=cfg, width_scale=WS,
                       updates={k: 2 for k in ("speech", "rir", "echoed", "finetune", "location", "location_joint")},
                       preset="fixed", joint_location=True, device="cpu", verbose=False, mesh=dp,
                       cache_frozen=True)
    out["pipeline"] = {k: v[0] for k, v in res.items()}
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------- the parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _latent_rows(branch, x, seed):
    """K pre-VQ latent rows of ``x`` as the branch's quantizer sees them
    (codebooks far from near ties)."""
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _random_tree(model, *inputs, seed=0):
    """Seeded weights of the shapes ``model.init`` gives (traced, not
    compiled): U(+-1/sqrt(fan_in)) for every kernel and bias, and the EMA
    buffers where the model has them."""
    import jax

    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else int(s.shape[0])
        bound = 1.0 / np.sqrt(max(fan_in, 1))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_weights():
    """JAX parameter trees and the port's state dicts on the same weights:
    the speech stage (gradient and EMA codebook) and a grafted composite,
    each codebook made of latent rows."""
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
    from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax, params_from_jax

    out = {}
    x = jnp.zeros((1, 201, T_SPEECH))
    xs = _speech_task().model_inputs(_torch_batch(_batch(2, 201, T_SPEECH, 11)))[0]
    for ema in (False, True):
        jm = jtrain.SpeechVQVAETask(width_scale=WS, vq_ema=ema).build_model()
        variables = _random_tree(jm, x, seed=2)
        p, stats = variables["params"], variables.get("vq_stats")
        model = _speech_task(ema).build_model()
        model.load_state_dict(params_from_jax(p, 3, vq_stats=stats))
        cb = _latent_rows(model, xs, 12)
        if ema:
            stats["_vq"].update(codebook=cb, ema_sums=cb * 1.5,
                                ema_counts=np.random.default_rng(13).uniform(0.5, 2.0, cb.shape[0]).astype(np.float32))
        else:
            p["_vq"]["codebook"] = cb
        out["ema" if ema else "speech"] = (p, stats, params_from_jax(p, 3, vq_stats=stats))

    cfg = JaxDatasetConfig(**ECHOED)
    kw = dict(config=cfg, width_scale=WS, compat_vq_flatten=True)
    f, t = cfg.num_freq, cfg.num_frames
    xe, xr = jnp.zeros((1, f, t)), jnp.zeros((1, t, f))
    speech_p = _random_tree(jtrain.SpeechVQVAETask(**kw).build_model(), xe, seed=4)["params"]
    rir_p = _random_tree(jtrain.RirVQVAETask(**kw).build_model(), xr, seed=5)["params"]
    fresh = _random_tree(jtrain.EchoedSpeechTask(**kw).build_model(), xe, xr, seed=6)["params"]
    p = _np(jtrain.graft_pretrained(fresh, speech_p, rir_p))
    model = _echoed_task().build_model()
    model.load_state_dict(composite_params_from_jax(p))
    s_in, r_in = _echoed_task().model_inputs(_torch_batch(_batch(2, f, t, 10)))
    p["speech_model"]["_vq"]["codebook"] = _latent_rows(model.speech_model, s_in, 11)
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, r_in, 12)
    out["echoed"] = (p, None, composite_params_from_jax(p))
    return out


def _jax_mesh_steps(jtask, params, stats, batch, reseed=False):
    """STEPS steps of JAX's Trainer on make_mesh(data=2) from ``params``:
    the metrics of each step, the final params and the final vq_stats."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
    from acoustic_locating_vq_vae_tpu.parallel import make_mesh
    from acoustic_locating_vq_vae_tpu.train import Trainer as JaxTrainer
    from acoustic_locating_vq_vae_tpu.train.loop import TrainState

    tr = JaxTrainer(jtask, mesh=make_mesh(data=WORLD), verbose=False)
    if reseed:
        tr.model = dataclasses.replace(tr.model, vq_ema_reset=RESEED)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tr.optimizer.init(p),
                       rng=jax.random.PRNGKey(0),
                       variables={"vq_stats": jax.tree_util.tree_map(jnp.asarray, stats)} if stats else {})
    jb = JaxSampleBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    metrics = []
    for _ in range(STEPS):
        state, m = tr._step_fn(state, jb, B, True)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _np(state.params), _np(state.variables.get("vq_stats")) if stats else None


def _fixed_jax_jitter(x, key, probability, per_batch=False):
    """Stands in for JAX's ``ops.jitter.jitter``: the same gather with the
    decisions of :func:`_masks`."""
    import jax
    import jax.numpy as jnp

    length = x.shape[1]
    replace, forward = (jnp.asarray(m) for m in _masks(length, probability))
    pos = jnp.arange(length)
    neighbor = pos + jnp.where(forward, 1, -1)
    neighbor = jnp.where(pos == 0, 1, neighbor)
    neighbor = jnp.where(pos == length - 1, length - 2, neighbor)
    idx = jnp.where(replace, neighbor, pos)
    return jnp.where(replace[None, :, None], jax.lax.stop_gradient(x[:, idx, :]), x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks, compute the single-process and JAX references
    while they run, and return ``(ranks' results, references, root)``."""
    import jax

    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
    from acoustic_locating_vq_vae_tpu.train import loop as jloop

    from acoustic_locating_vq_vae_torch import data as port_data

    root = tmp_path_factory.mktemp("dp")
    weights = _jax_weights()
    batches = {"speech_batch": _batch(B, 201, T_SPEECH, 20), "odd_batch": _batch(3, 201, T_SPEECH, 21),
               "echoed_batch": _batch(B, ECHOED_CFG.num_freq, ECHOED_CFG.num_frames, 22),
               "host_rows": _batch(12, 201, 8, 23)}
    otf = {"otf_bank": port_data.make_rir_bank(OTF_CFG, n_theta=8, chunk=OTF_CHUNK, batch=4, device="cpu"),
           "otf_val": port_data.make_dataset(torch.Generator().manual_seed(1), 8, OTF_CFG, batch=8, device="cpu",
                                             rir_chunk=OTF_CHUNK),
           "otf_composite": Trainer(EchoedSpeechTask(config=OTF_CFG, width_scale=WS, batch_size=8,
                                                     compat_vq_flatten=False),
                                    device="cpu", seed=40, verbose=False).model.state_dict()}
    torch.save({**batches, **otf, **{k: v[2] for k, v in weights.items()}}, root / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1] / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        # the single-process port steps on the whole batches
        pj, jjitter = _jitter_module("acoustic_locating_vq_vae_torch"), _jitter_module("acoustic_locating_vq_vae_tpu")
        saved = pj.jitter_decisions, jjitter.jitter, jloop.sample_without_replacement
        pj.jitter_decisions = _fixed_decisions
        jjitter.jitter = _fixed_jax_jitter
        jloop.sample_without_replacement = lambda key, n, k: jax.numpy.arange(k)
        try:
            speech, echoed = _torch_batch(batches["speech_batch"]), _torch_batch(batches["echoed_batch"])
            ref = {
                "speech": _run_steps(_trainer(_speech_task(), weights["speech"][2]), speech),
                "odd": _run_steps(_trainer(_speech_task(batch_size=3), weights["speech"][2]),
                                  _torch_batch(batches["odd_batch"])),
                "ema": _run_steps(_trainer(_speech_task(ema=True), weights["ema"][2], reseed=True), speech),
                "echoed": _run_steps(_trainer(_echoed_task(), weights["echoed"][2]), echoed),
                "echoed_cached": _run_steps(_trainer(_echoed_task(), weights["echoed"][2]), echoed, cached=True),
            }
            ref["host"] = _host_fit(batches["host_rows"])
            for dtype in ("bfloat16", "float32"):
                ref[f"one_step_{dtype}"] = _one_step(
                    _trainer(SpeechVQVAETask(width_scale=WS, batch_size=B, compute_dtype=dtype), weights["speech"][2]),
                    speech)
            jcfg = JaxDatasetConfig(**ECHOED)
            jax_ref = {
                "speech": _jax_mesh_steps(jtrain.SpeechVQVAETask(width_scale=WS, batch_size=B), *weights["speech"][:2],
                                          batches["speech_batch"]),
                "ema": _jax_mesh_steps(jtrain.SpeechVQVAETask(width_scale=WS, batch_size=B, vq_ema=True),
                                       *weights["ema"][:2], batches["speech_batch"], reseed=True),
                "echoed": _jax_mesh_steps(jtrain.EchoedSpeechTask(config=jcfg, width_scale=WS, batch_size=B,
                                                                  compat_vq_flatten=True),
                                          *weights["echoed"][:2], batches["echoed_batch"]),
            }
        finally:
            pj.jitter_decisions, jjitter.jitter, jloop.sample_without_replacement = saved
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}" for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return got, ref, jax_ref, root


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _assert_matches_single(got, want, weight_atol=1e-7):
    """Metrics of every step and the gradients within DP_RTOL (a gradient's
    entries also within GRAD_ATOL_SHARE of its largest, where sums of terms
    of both signs cancel), the weights within DP_RTOL (atol ``weight_atol``)."""
    for gm, wm in zip(got["metrics"], want["metrics"]):
        for k in wm:
            _close(gm[k], wm[k], DP_RTOL, what=k)
    for k, g in want["grads"].items():
        _close(got["grads"][k], g, DP_RTOL, GRAD_ATOL_SHARE * float(g.abs().max()), what=k)
    for k, w in want["state"].items():
        _close(got["state"][k], w, DP_RTOL, weight_atol, what=k)


def _assert_matches_jax(got, jax_run, layers, composite=False):
    from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax, params_from_jax

    metrics, params, stats = jax_run
    for gm, wm in zip(got["metrics"], metrics):
        for k, v in wm.items():
            _close(gm[k], v, RTOL, what=k)
    want = composite_params_from_jax(params) if composite else params_from_jax(params, layers, vq_stats=stats)
    for k, w in want.items():
        _close(got["state"][k], w, RTOL, ATOL, what=k)


def test_ranks_hold_the_same_weights(runs):
    """Every rank ends every check with bitwise rank 0's weights and buffers."""
    got, _, _, _ = runs
    for name in ("speech", "odd", "ema", "echoed", "echoed_cached"):
        for k, v in got[0][name]["state"].items():
            assert torch.equal(v, got[1][name]["state"][k]), (name, k)
    for stage, sd in got[0]["pipeline"].items():
        for k, v in sd.items():
            assert torch.equal(v, got[1]["pipeline"][stage][k]), (stage, k)


@pytest.mark.parametrize("name", ["speech", "odd", "ema", "echoed", "echoed_cached"])
def test_dp_step_matches_single_process(runs, name):
    """The 2-rank step on a global batch equals the single-process step on
    it: gradient mode, unequal blocks (3 rows: 2 and 1, each rank weighted by
    its share), the EMA codebook with every code re-seeded, the echoed stage
    uncached and from the cache. Perplexities exactly (global code counts)."""
    got, ref, _, _ = runs
    # unequal blocks weight the ranks' gradients by 2/3 and 1/3, which round (halves do not), and Adam makes
    # a step of up to lr of a gradient entry near zero whatever its size: there, the weights within 1% of lr
    _assert_matches_single(got[0][name], ref[name], weight_atol=1e-2 * LR if name == "odd" else 1e-7)
    for gm, wm in zip(got[0][name]["metrics"], ref[name]["metrics"]):
        for k in wm:
            if "perplexity" in k:
                assert float(gm[k]) == float(wm[k]), k


def test_dp_ema_buffers_and_reseeding(runs):
    """EMA counts exact and sums within 1e-5 relative of the single process;
    the re-seeded codebook is made of global rows k mod N (the single
    process's rows), not each rank's own."""
    got, ref, _, _ = runs
    g, w = got[0]["ema"]["state"], ref["ema"]["state"]
    assert torch.equal(g["_vq.ema_counts"], w["_vq.ema_counts"])
    _close(g["_vq.ema_sums"], w["_vq.ema_sums"], 1e-5, 1e-7)
    _close(g["_vq._embedding.weight"], w["_vq._embedding.weight"], 1e-5, 1e-7)
    assert torch.equal(g["_vq._embedding.weight"], got[1]["ema"]["state"]["_vq._embedding.weight"])


@pytest.mark.parametrize("name,layers", [("speech", 3), ("ema", 3), ("echoed", None)])
def test_dp_step_matches_jax_mesh(runs, name, layers):
    """The 2-rank step equals JAX's Trainer on make_mesh(data=2) on the same
    weights and batch: every metric (the global perplexities among them),
    the weights after two Adam steps and the EMA buffers with every code
    re-seeded from a global row."""
    got, _, jax_ref, _ = runs
    _assert_matches_jax(got[0][name], jax_ref[name], layers, composite=name == "echoed")


def test_stratified_sampling_draws_from_each_rank_block(runs):
    """12 rows over 2 ranks: each rank holds its 6-row block and draws 2
    distinct rows of it a step, from its own stream; sample() on the whole
    set draws from the same block."""
    got, _, _, _ = runs
    for r, res in enumerate(got):
        block = list(range(6 * r, 6 * r + 6))
        assert res["block"] == block
        for draw in res["draws"] + [res["sample"]]:
            assert len(draw) == 2 and len(set(draw)) == 2 and set(draw) <= set(block), (r, draw)
    assert got[0]["draws"] != [[d - 6 for d in draw] for draw in got[1]["draws"]]  # the rank is folded in


def test_non_divisible_set_warns_and_splits_a_shared_draw(runs):
    """7 rows over 2 ranks: a warning, every rank holds the whole set, and
    the ranks' rows are the blocks of one global draw from the shared
    generator (seed + 1), distinct across the ranks."""
    got, _, _, _ = runs
    want = torch.randperm(7, generator=torch.Generator().manual_seed(1))[:B]  # _trainer's seed 0, plus 1
    for r, res in enumerate(got):
        assert any("not divisible" in m for m in res["odd_warned"]), res["odd_warned"]
        assert res["odd_held"] == list(range(7))
    draw = got[0]["odd_draw"] + got[1]["odd_draw"]
    assert len(set(draw)) == B
    assert draw == [float(i) for i in want]


def test_dp_fit_preempted_on_one_rank_and_resumed_is_bitwise(runs):
    """A SIGTERM's flag on rank 1 alone stops both ranks at the same step;
    rank 0 writes the checkpoint with both ranks' generators, and the
    resumed fit ends bitwise equal to an uninterrupted 2-rank fit (eval
    steps and a periodic checkpoint included). A resume at world size 1
    raises."""
    got, _, _, root = runs
    for res in got:
        assert res["preempted_at"] == 3 and res["resumed_at"] == 5 and res["fit_bitwise"]
    for k, v in got[0]["fit_state"].items():
        assert torch.equal(v, got[1]["fit_state"][k]), k
    task = SpeechVQVAETask(width_scale=WS, batch_size=4, eval_every=3, ckpt_every=2, num_updates=5)
    single = Trainer(task, device="cpu", seed=3, verbose=False, checkpoint_dir=str(root / "fit_cut"))
    with pytest.raises(ValueError, match="same world size"):
        single.restore_latest()


def test_dp_host_staged_fit_matches_single_process(runs):
    """Two ranks over the chunks of a host-staged set, each holding its
    block of the chunk, train as one process does: every step's loss and
    the weights within DP_RTOL, the ranks' weights bitwise equal."""
    got, ref, _, _ = runs
    _close(got[0]["host"]["loss"], ref["host"]["loss"], DP_RTOL, what="loss")
    for k, w in ref["host"]["state"].items():
        _close(got[0]["host"]["state"][k], w, DP_RTOL, 1e-7, what=k)
        assert torch.equal(got[0]["host"]["state"][k], got[1]["host"]["state"][k]), k


def test_replicas_must_start_equal(runs):
    """Weights drawn from different seeds on the ranks raise on every rank;
    replicate() broadcasts rank 0's weights (seeded 0) to rank 1 (seeded 1)."""
    got, _, _, _ = runs
    for res in got:
        assert res["replica_error"] and "differ between the ranks" in res["replica_error"]
    torch.manual_seed(0)
    want = torch.nn.Linear(3, 2).state_dict()
    for res in got:
        for k, v in want.items():
            assert torch.equal(res["replicated"][k], v), k


def test_dp_pipeline_writes_one_store(runs):
    """run_pipeline(mesh=...) over 2 ranks trains all six stages;
    rank 0 alone wrote the store, which holds every final with its
    metadata."""
    from acoustic_locating_vq_vae_torch.utils import StageStore

    got, _, _, root = runs
    store = StageStore(str(root / "pipeline"))
    stages = ("speech", "rir", "echoed", "finetune", "location", "location_joint")
    assert set(got[0]["pipeline"]) == set(stages)
    for s in stages:
        assert store.stage_metadata(s)["final"]
        saved = store.load_stage(s)
        assert "data_parallel" in saved and saved["data_parallel"]["world_size"] == WORLD
        for k, v in got[0]["pipeline"][s].items():
            assert torch.equal(saved["model"][k], v), (s, k)


def _rel(a, b) -> float:
    """``||a - b|| / ||b||`` in float64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_dp_bf16_step_meets_the_bf16_criterion(runs):
    """A bf16 step on 2 ranks against the single-process bf16 step: every
    metric and gradient lies within HALF of the single process's bf16
    distance from its float32 step (test_torch_bf16.py's criterion, with the
    port's single process as the reference), or within F32_REL of it where
    bf16 lies within float32 rounding of float32; perplexities exactly.

    One term is the data split's own and is allowed beside HALF: a weight's
    cotangent is bf16 (flax casts the weight to bf16), so each rank rounds its
    share of a gradient to bf16 before the sum over the ranks, where one
    process rounds the whole once. That moves every gradient by up to one bf16
    rounding (BF16_UNIT, 2^-8 relative); the readings were 1.2e-3 to 2.7e-3.
    Where bf16's own distance from float32 is about one rounding (the last
    transposed conv's bias, 2.8e-3), that term is above HALF of it (2.4e-3:
    ratio 0.86), so the bound is the larger of the two."""
    got, ref, _, _ = runs
    one, b16, f32 = got[0]["bf16"], ref["one_step_bfloat16"], ref["one_step_float32"]
    pairs = [(f"metric {k}", one["metrics"][k], b16["metrics"][k], f32["metrics"][k]) for k in b16["metrics"]]
    pairs += [(f"grad {k}", one["grads"][k], g, f32["grads"][k]) for k, g in b16["grads"].items()]
    assert set(one["grads"]) == set(b16["grads"])
    for what, g, w16, w32 in pairs:
        dist, scale = _rel(g, w16), _rel(w16, w32)
        assert dist <= (F32_REL if scale <= F32_REL else max(HALF * scale, BF16_UNIT)), (what, dist, scale)
    assert float(one["metrics"]["perplexity"]) == float(b16["metrics"]["perplexity"])
    for k, v in got[0]["bf16"]["grads"].items():
        assert torch.equal(v, got[1]["bf16"]["grads"][k]), k


def test_dp_on_the_fly_recipe_resumes_bitwise(runs):
    """The on-the-fly bank->exact joint recipe on 2 ranks (each rank its
    block of every synthesized batch): the ranks' weights bitwise equal, and
    a recipe preempted on rank 1 in its polish leg stops both ranks at the
    same step and, resumed at the same world size, ends bitwise equal to the
    uninterrupted recipe."""
    got, _, _, _ = runs
    for res in got:
        assert res["otf_preempted_at"] == 3 and res["otf_resumed_at"] == 4
        for k, v in res["otf_state"].items():
            assert torch.equal(v, got[0]["otf_state"][k]), k
            assert torch.equal(res["otf_resumed"][k], v), k


# ---------------------------------------------------------------- no spawn


def test_handles_and_blocks():
    """The world-size-1 handle has no group; blocks split rows as
    np.array_split; rank 0 keeps the seed; shard_batch takes the block."""
    one = local_mesh("cpu")
    assert one.group is None and one.world_size == 1 and not one.distributed
    assert one.any(True) and not one.any(False)
    for n in (4, 7, 12):
        blocks = [DataParallel(None, r, 3, torch.device("cpu")).block(n) for r in range(3)]
        want = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), 3)])
        assert blocks == [(int(want[r]), int(want[r + 1])) for r in range(3)]
    assert rank_seed(11, 0) == 11 and rank_seed(11, 1) != rank_seed(11, 2) != 11
    b = _torch_batch(_batch(5, 4, 3, 0))
    part = shard_batch(b, DataParallel(None, 1, 2, torch.device("cpu")))
    assert torch.equal(part.theta, b.theta[3:5])


def test_trainer_with_local_mesh_is_the_plain_trainer():
    """A handle without a group is no handle: the same draws and steps,
    bitwise."""
    data = _torch_batch(_batch(6, 201, 8, 1))
    a = Trainer(_speech_task(), device="cpu", seed=4, verbose=False)
    b = Trainer(_speech_task(), device="cpu", seed=4, verbose=False, mesh=local_mesh("cpu"))
    for _ in range(2):
        ma, mb = a.step(a.sample(data)), b.step(b.sample(data))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()))


@pytest.mark.parametrize("flags", [["--mesh-seq", "2"], ["--mesh-model", "2"], ["--mesh-slices", "2"],
                                   ["--sequence-parallel", "--preset", "compat"],
                                   ["--model-parallel", "--mesh-model", "2"]],
                         ids=["mesh_seq", "mesh_model", "mesh_slices", "sequence_parallel", "model_parallel"])
def test_axes_of_the_next_slice_raise(flags, tmp_path, monkeypatch):
    """The pipeline CLI takes the JAX mesh flags (since the model, sequence
    and multi-node axes were ported): outside torchrun an axis above one
    raises for the missing process group, and --sequence-parallel with the
    compat VQ flatten raises JAX's error, both before any data is made;
    nothing raises NotImplementedError. (Runs under torchrun:
    tests/test_torch_sequence_parallel.py.)"""
    from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    want = (ValueError, "vectors VQ flatten") if "--sequence-parallel" in flags else (RuntimeError, "torchrun")
    with pytest.raises(want[0], match=want[1]):
        cli.main(["--smoke", "--device", "cpu", "--store-dir", str(tmp_path), *flags])


def test_data_parallel_needs_its_group(monkeypatch, tmp_path):
    """--data-parallel outside torchrun, NCCL without a card and a card
    without CUDA raise; nothing carries on in one process."""
    from acoustic_locating_vq_vae_torch.cli import run_pipeline as cli

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--smoke", "--device", "cpu", "--store-dir", str(tmp_path), "--data-parallel"])
    with pytest.raises(SystemExit, match="--data-parallel"):
        cli.main(["--smoke", "--device", "cpu", "--store-dir", str(tmp_path), "--mesh-data", "2"])
    with pytest.raises(ValueError, match="NCCL"):
        init_data_parallel(backend="nccl", device="cpu", rank=0, world_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            init_data_parallel(device="cuda", rank=0, world_size=1)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
