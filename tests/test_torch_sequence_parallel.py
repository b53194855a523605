"""The port's sequence sharding, tensor sharding and multi-node layouts on the
CPU: four gloo ranks against the port's single process and against the JAX
package on the same carried weights.

Counterparts: the 19 test functions of ``tests/test_sequence_parallel.py``,
``tests/test_dp_collectives.py:89-176`` (the model-parallel step, the model
axis's collectives, the multi-slice groups) and the 6 of
``tests/test_multislice.py``; and the port's own: the cross-shard tie merge of
the codebook split, the partition decisions against JAX's at full width, a
store resumed across model axis sizes.

One spawn per module: the fixture starts four worker processes (this file run
as a script, ranks 0-3 over gloo on localhost), which lay the four ranks out as
each check's mesh (``seq = 4``; ``data = 2 x seq = 2``; ``data = 2 x model =
2``, also on two fake nodes; ``data = 4`` on two fake nodes; ``model = 4``),
run it and save what they saw; meanwhile the parent computes the JAX references
(JAX's own meshes on the 8 virtual CPU devices) and the port's single-process
steps. The workers import torch and the port only.

The JAX package shards its sequences inside ``shard_map`` and folds the shard
index into its jitter key; the port's jitter reads its window of one global
draw, so the comparisons with JAX run eval steps or fix the decisions (the
model-parallel train step replays fixed decisions in both packages, as
``test_torch_parallel.py`` does). Tolerances: rtol 1e-4 / atol 1e-5 against
JAX in FP32 unless a test states otherwise; against the port's own single
process rtol 1e-5, a gradient's entries also within 1e-4 of its largest (sums
in another order); jitter, the merged codes and the layouts exactly.
"""

import importlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.parallel import (
    DataParallel,
    init_data_parallel,
    make_mesh,
    mesh_layout,
    param_partition_spec,
    shard_batch,
)
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask,
    EncoderFinetuneTask,
    SpeechVQVAETask,
    Trainer,
)

WORLD = 4
SMALL = dict(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)  # 33 bins x 100 frames
LONG = dict(n_sample=512, audio_samples=64128, num_frames=2000, NFFT=64, HOP_LENGTH=32)  # 33 bins x 2000 frames
SMALL_CFG, LONG_CFG = DatasetConfig(**SMALL), DatasetConfig(**LONG)
WS = 1 / 32
MP_WS = 0.25  # widths of 256, the least the partition rules split
B = 8
SP_CFG = dict(in_channels=5, num_hiddens=8, embedding_dim=4, num_residual_layers=2, num_residual_hiddens=6,
              commitment_cost=0.25, num_embeddings=16, compat_vq_flatten=False)
RTOL, ATOL = 1e-4, 1e-5
SP_RTOL = 1e-5  # against the port's own single process
GRAD_ATOL_SHARE = 1e-4
LR = 1e-3
JITTER_SEED = 900
TRAIN_GEN = 7
# the pipeline CLI under torchrun, two gloo ranks at the smoke size: (flags, width) by name
CLI_RUNS = {"seq": (["--mesh-seq", "2", "--sequence-parallel"], "0.03125"),
            "model": (["--mesh-model", "2", "--model-parallel"], "0.25")}


# ---------------------------------------------------------------- shared helpers (parent and workers)


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


def _masks(length: int, probability: float):
    rng = np.random.default_rng(JITTER_SEED + length)
    return rng.random(length) < probability, rng.random(length) < 0.5


def _fixed_decisions(shape, probability, generator=None):
    """Stands in for the port's ``ops.jitter.jitter_decisions``."""
    replace, forward = _masks(shape[-1], probability)
    return (torch.from_numpy(np.broadcast_to(replace, shape).copy()),
            torch.from_numpy(np.broadcast_to(forward, shape).copy()))


def _sp_model():
    from acoustic_locating_vq_vae_torch.models import ConvolutionalVQVAE

    return ConvolutionalVQVAE(**SP_CFG, sequence_axis="seq")


def _speech_task(**kw):
    return SpeechVQVAETask(config=SMALL_CFG, width_scale=WS, batch_size=B, sequence_axis="seq", **kw)


def _echoed_task(cfg=SMALL_CFG, batch_size=B):
    return EchoedSpeechTask(config=cfg, width_scale=WS, batch_size=batch_size, sequence_axis="seq")


def _finetune_task():
    return EncoderFinetuneTask(config=SMALL_CFG, width_scale=WS, batch_size=B, sequence_axis="seq",
                               commitment_weight=0.25)


def _mp_task(**kw):
    return SpeechVQVAETask(**{"config": SMALL_CFG, "width_scale": MP_WS, "batch_size": B, **kw})


def _grads(model):
    """Every parameter's whole gradient by each of its names (a tied block's
    at every layer index), the split ones gathered over the model axis."""
    out, whole = {}, {}
    for name, p in model.named_parameters(remove_duplicate=False):
        if p.grad is not None:
            if id(p) not in whole:
                shard = getattr(p, "model_shard", None)
                whole[id(p)] = (shard.gather(p.grad) if shard is not None else p.grad).clone()
            out[name] = whole[id(p)]
    return out


def _f64_step(tr, inputs, mesh=None):
    """The model-parallel check's step in float64 (the trainer's model and
    batch cast): its gradients and the weights after it."""
    tr.load_state_dict(inputs["mp"])
    tr.model.double()
    batch = _torch_batch(inputs["mp_batch"]).map(lambda a: a.double() if a.is_floating_point() else a)
    tr.step(batch if mesh is None else shard_batch(batch, mesh))
    return dict(grads=_grads(tr.model), state=tr.state_dict())


def _sp_grads(model, x, mesh=None, generator=None, train=False):
    """The SP model's loss ``mean((recon - x)^2) + vq_loss`` and its gradients:
    on a mesh each rank's local loss, the gradients averaged over the seq axis."""
    from acoustic_locating_vq_vae_torch.parallel import sequence_parallel_apply

    model.zero_grad(set_to_none=True)
    if mesh is None:
        vq_loss, recon, _ = model(x, train=train, generator=generator)
        target = x
    else:
        vq_loss, recon, _ = sequence_parallel_apply(model, x, mesh, train=train, generator=generator)
        _, s, n = mesh.axis("seq")
        per = x.shape[-1] // n
        target = x[..., s * per:(s + 1) * per]
    loss = torch.mean((recon - target) ** 2) + vq_loss
    loss.backward()
    grads = {k: v for k, v in model.named_parameters() if v.grad is not None}
    if mesh is not None:
        for p in grads.values():
            mesh.all_reduce_(p.grad, axis="seq").div_(mesh.seq_size)
    value = loss.detach().clone()
    if mesh is not None:
        value = mesh.all_reduce_(value, axis="seq") / mesh.seq_size
    return float(value), {k: p.grad.clone() for k, p in grads.items()}


class _Collectives:
    """Counts the collectives ``torch.distributed`` runs, by kind and by the
    global ranks of their group, while :meth:`window` is open."""

    KINDS = ("all_reduce", "batch_isend_irecv", "broadcast", "all_gather", "reduce_scatter", "send", "recv")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.seen, self.open = dist, [], False
        for kind in self.KINDS:
            fn = getattr(dist, kind)
            setattr(dist, kind, self._wrap(kind, fn))

    def _wrap(self, kind, fn):
        def call(*args, **kwargs):
            if self.open:
                if kind == "batch_isend_irecv":
                    group = args[0][0].group if args[0] else None
                else:
                    group = kwargs.get("group")
                ranks = tuple(sorted(self.dist.get_process_group_ranks(group))) if group is not None else "world"
                self.seen.append((kind, ranks))
            return fn(*args, **kwargs)
        return call

    def window(self):
        counter = self

        class _W:
            def __enter__(self):
                counter.seen, counter.open = [], True
                return counter.seen

            def __exit__(self, *exc):
                counter.open = False

        return _W()


# ---------------------------------------------------------------- the worker


def _worker(rank: int, port: int, root: Path) -> None:
    import torch.distributed as dist

    from acoustic_locating_vq_vae_torch.parallel import (
        make_dp_train_step, reduce_gradients, sequence_sharded_conv, sharded_conv1d,
    )
    from acoustic_locating_vq_vae_torch.parallel.dp_step import step_weight

    port_jitter = importlib.import_module("acoustic_locating_vq_vae_torch.ops.jitter")
    torch.set_num_threads(1)
    world = init_data_parallel(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    counter = _Collectives()
    out = {}

    # --- seq = 4: the conv, the halo, the model, the jitter, the long composite
    seq4 = make_mesh(seq=4, world=world)
    x = torch.from_numpy(inputs["conv_x"])
    for k in (1, 3):
        w, b = (torch.from_numpy(a) for a in inputs[f"conv_w{k}"])
        out[f"conv{k}"] = sequence_sharded_conv(x, w, seq4, bias=b)
    w3 = torch.from_numpy(inputs["halo_w"])
    halo_x = torch.from_numpy(inputs["halo_x"])
    per = halo_x.shape[-1] // 4
    with counter.window() as seen:
        out["halo_out"] = sharded_conv1d(halo_x[..., rank * per:(rank + 1) * per], w3, seq4)
    out["halo_traffic"] = list(seen)

    model = _sp_model()
    for name in ("sp_fwd", "sp_long"):
        model.load_state_dict(inputs[name]["weights"])
        with torch.no_grad():
            from acoustic_locating_vq_vae_torch.parallel import sequence_parallel_apply

            loss, recon, perp = sequence_parallel_apply(model, torch.from_numpy(inputs[name]["x"]), seq4)
        out[name] = (float(loss), recon, float(perp))
    model.load_state_dict(inputs["sp_grad"]["weights"])
    out["sp_grad"] = _sp_grads(model, torch.from_numpy(inputs["sp_grad"]["x"]), seq4)
    model.load_state_dict(inputs["sp_train"]["weights"])
    out["sp_train"] = _sp_grads(model, torch.from_numpy(inputs["sp_train"]["x"]), seq4,
                                torch.Generator().manual_seed(TRAIN_GEN), train=True)

    # the jitter of positions 0..63 with one global draw at p = 0.5
    pos = torch.arange(64, dtype=torch.float32)[None, None, :].expand(1, 3, 64)
    replace, forward = port_jitter.jitter_decisions((64,), 0.5, torch.Generator().manual_seed(0))
    window = slice(rank * 16, (rank + 1) * 16)
    out["jitter"] = port_jitter.jitter_sharded(pos[..., window], replace[window], forward[window], seq4)

    long_tr = Trainer(_echoed_task(LONG_CFG, 2), device="cpu", seed=0, verbose=False, mesh=seq4)
    long_tr.load_state_dict(inputs["long"])
    out["long"] = long_tr.step(_torch_batch(inputs["long_batch"]), train=False)

    # --- data = 2 x seq = 2: the speech, echoed and finetune stages through the trainer
    ds = make_mesh(data=2, seq=2, world=world)
    speech = shard_batch(_torch_batch(inputs["speech_batch"]), ds)
    tr = Trainer(_speech_task(), device="cpu", seed=0, verbose=False, mesh=ds)
    tr.load_state_dict(inputs["speech"])
    out["speech_eval"] = tr.step(speech, train=False)
    drawn, port_jitter.jitter_decisions = port_jitter.jitter_decisions, _fixed_decisions
    tr = Trainer(_speech_task(), device="cpu", seed=0, verbose=False, mesh=ds)
    tr.load_state_dict(inputs["speech"])
    out["speech_train"] = (tr.step(speech), tr.state_dict())
    port_jitter.jitter_decisions = drawn
    fit = Trainer(_speech_task(), device="cpu", seed=1, verbose=False, mesh=ds,
                  checkpoint_dir=str(root / "speech_store"))
    out["speech_fit"] = fit.fit(_torch_batch(inputs["fit_batch"]), None, num_updates=30).finalize()
    echoed = shard_batch(_torch_batch(inputs["echoed_batch"]), ds)
    tr = Trainer(_echoed_task(), device="cpu", seed=0, verbose=False, mesh=ds)
    tr.load_state_dict(inputs["echoed"])
    out["echoed_eval"] = tr.step(echoed, train=False)
    fit = Trainer(_echoed_task(), device="cpu", seed=2, verbose=False, mesh=ds)
    fit.load_state_dict(inputs["echoed"])
    out["echoed_fit"] = fit.fit(_torch_batch(inputs["echoed_batch"]), None, num_updates=20).finalize()
    tr = Trainer(_finetune_task(), device="cpu", seed=0, verbose=False, mesh=ds)
    tr.load_state_dict(inputs["echoed"])
    part = tr._time_window(echoed)
    with tr._step_context():
        loss, _ = tr._loss(part, False, None)
        loss.backward()
    reduce_gradients([p for p in tr.model.parameters() if p.grad is not None], ds,
                     step_weight(int(part.speech_spec.shape[0]), ds, torch.device("cpu")))
    out["finetune_grads"] = _grads(tr.model)

    # --- data = 2 x model = 2: one train step with fixed jitter decisions, its collectives by group
    drawn, port_jitter.jitter_decisions = port_jitter.jitter_decisions, _fixed_decisions
    for label, kw in (("mp", {}), ("multislice", dict(slices=2, slice_map={r: r % 2 for r in range(WORLD)}))):
        mesh = make_mesh(data=2, model=2, world=world, **kw)
        tr = Trainer(_mp_task(), device="cpu", seed=0, verbose=False, mesh=mesh, model_parallel=True)
        tr.load_state_dict(inputs["mp"])
        local = {k: p.numel() for k, p in tr.model.named_parameters()}
        with counter.window() as seen:
            metrics = tr.step(shard_batch(_torch_batch(inputs["mp_batch"]), mesh))
        out[label] = dict(metrics=metrics, collectives=list(seen), local=local, lines=mesh.lines,
                          coords=(mesh.rank, mesh.model_rank, mesh.seq_rank))
    out["mp"].update(_f64_step(Trainer(_mp_task(), device="cpu", seed=0, verbose=False, mesh=mesh,
                                       model_parallel=True), inputs, mesh))
    port_jitter.jitter_decisions = drawn

    # --- data = 4 on two fake nodes: a plain step's numerics are the single device's
    s4 = make_mesh(data=4, slices=2, slice_map={r: r % 2 for r in range(WORLD)}, world=world)
    lin = inputs["linear"]
    w = torch.nn.Parameter(torch.from_numpy(lin["w"]).clone())
    opt = torch.optim.Adam([w], lr=1e-2)
    xb, yb = (shard_batch(torch.from_numpy(lin[k]), s4) for k in ("x", "y"))

    def loss_fn(batch):
        loss = torch.mean((batch[0] @ w - batch[1]) ** 2)
        return loss, {"mse": loss}

    out["sliced"] = (make_dp_train_step(loss_fn, opt, s4)((xb, yb), rows=int(xb.shape[0])), w.detach().clone(),
                     s4.lines, s4.rank)

    # --- model = 4: a single-process store resumed, and a store written for a single process
    m4 = make_mesh(model=4, world=world)
    store_task = _mp_task(batch_size=4, ckpt_every=2, num_updates=4, eval_every=1000)
    fit_rows = _torch_batch(inputs["store_batch"])
    tr = Trainer(store_task, device="cpu", seed=5, verbose=False, mesh=m4, model_parallel=True,
                 checkpoint_dir=str(root / "store_single"))
    tr.fit(fit_rows, None, resume=True)
    out["resumed_state"] = tr.state_dict()
    out["resumed_at_model4"] = tr.step_count
    tr = Trainer(store_task, device="cpu", seed=5, verbose=False, mesh=m4, model_parallel=True,
                 checkpoint_dir=str(root / "store_model4"))
    tr.fit(fit_rows, None, num_updates=2)
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------- the parent


def _cli_argv(store: Path, name: str, *extra) -> list:
    flags, width = CLI_RUNS[name]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
            "acoustic_locating_vq_vae_torch.cli.run_pipeline", "--smoke", "--device", "cpu", "--width-scale", width,
            "--updates", "2", "--dataset-size", "8", "--val-size", "4", "--store-dir", str(store), *flags, *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _random_tree(model, *inputs, seed=0):
    """Seeded weights of the shapes ``model.init`` gives (traced, not
    compiled): U(+-1/sqrt(fan_in)) for every kernel and bias."""
    import jax

    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else int(s.shape[0])
        bound = 1.0 / np.sqrt(max(fan_in, 1))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _latent_rows(branch, x, seed):
    """K pre-VQ latent rows of ``x`` as the branch's quantizer sees them
    (codebooks far from near ties)."""
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _vqvae_weights(jmodel, port_model, x, layers, seed):
    """(JAX params, the port's state dict) of seeded weights, the codebook
    made of latent rows of ``x``."""
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_torch.eval import params_from_jax

    p = _np(_random_tree(jmodel, jnp.zeros((1, x.shape[1], 16)), seed=seed))
    port_model.load_state_dict(params_from_jax(p, layers))
    p["_vq"]["codebook"] = _latent_rows(port_model, torch.from_numpy(x), seed)
    return p, params_from_jax(p, layers)


def _composite_weights(cfg, seed):
    """(JAX params, the port's state dict) of a grafted composite (vectors
    flatten), both codebooks made of latent rows."""
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax

    jcfg = _jax_cfg(cfg)
    kw = dict(config=jcfg, width_scale=WS, compat_vq_flatten=False)
    f, t = cfg.num_freq, cfg.num_frames
    xe, xr = jnp.zeros((1, f, 16)), jnp.zeros((1, t, f))
    speech_p = _random_tree(jtrain.SpeechVQVAETask(**kw).build_model(), xe, seed=seed)
    rir_p = _random_tree(jtrain.RirVQVAETask(**kw).build_model(), xr, seed=seed + 1)
    fresh = _random_tree(jtrain.EchoedSpeechTask(**kw).build_model(), xe, xr, seed=seed + 2)
    p = _np(jtrain.graft_pretrained(fresh, speech_p, rir_p))
    task = EchoedSpeechTask(config=cfg, width_scale=WS, compat_vq_flatten=False)
    model = task.build_model()
    model.load_state_dict(composite_params_from_jax(p))
    s_in, r_in = task.model_inputs(_torch_batch(_batch(2, f, t, seed + 3)))
    p["speech_model"]["_vq"]["codebook"] = _latent_rows(model.speech_model, s_in, seed)
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, r_in, seed + 1)
    return p, composite_params_from_jax(p)


def _jax_cfg(cfg):
    from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig

    return JaxDatasetConfig(n_sample=cfg.n_sample, audio_samples=cfg.audio_samples, num_frames=cfg.num_frames,
                            NFFT=cfg.NFFT, HOP_LENGTH=cfg.HOP_LENGTH)


def _jax_state(tr, params):
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu.train.loop import TrainState

    p = jax.tree_util.tree_map(jnp.asarray, params)
    return TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tr.optimizer.init(p),
                      rng=jax.random.PRNGKey(0), variables={})


def _jax_step(jtask, params, batch, mesh_kw, train=False):
    """Metrics of one JAX Trainer step on ``make_mesh(**mesh_kw)`` from
    ``params`` over the whole ``batch`` (and the params after it)."""
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
    from acoustic_locating_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
    from acoustic_locating_vq_vae_tpu.train import Trainer as JaxTrainer

    tr = JaxTrainer(jtask, mesh=jax_make_mesh(**mesh_kw), verbose=False)
    jb = JaxSampleBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    state, m = tr._step_fn(_jax_state(tr, params), jb, batch["theta"].shape[0], train)
    return {k: float(v) for k, v in m.items()}, _np(state.params)


def _jax_finetune_grads(params, batch):
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
    from acoustic_locating_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
    from acoustic_locating_vq_vae_tpu.train import Trainer as JaxTrainer

    task = jtrain.EncoderFinetuneTask(config=_jax_cfg(SMALL_CFG), width_scale=WS, batch_size=B, sequence_axis="seq",
                                      commitment_weight=0.25)
    tr = JaxTrainer(task, mesh=jax_make_mesh(data=2, seq=1), verbose=False)
    jb = JaxSampleBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    p = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_fn(q):
        return tr._loss(q, jb, {"jitter": jax.random.PRNGKey(9)}, False, {}, None)[0]

    return _np(jax.jit(jax.grad(loss_fn))(p))


def _fixed_jax_jitter(x, key, probability, per_batch=False):
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


def _jax_refs(inputs, jax_params):
    """Everything the parent reads from the JAX package."""
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import models as jmodels
    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_tpu.train import loop as jloop

    jjitter = importlib.import_module("acoustic_locating_vq_vae_tpu.ops.jitter")  # the package exports a function of its name

    refs = {}
    for k in (1, 3):
        w, b = inputs[f"conv_w{k}"]
        x = jnp.asarray(inputs["conv_x"]).transpose(0, 2, 1)
        y = jax.lax.conv_general_dilated(x, jnp.asarray(w).transpose(2, 1, 0), (1,), "SAME",
                                         dimension_numbers=("NHC", "HIO", "NHC")) + jnp.asarray(b)
        refs[f"conv{k}"] = np.asarray(y).transpose(0, 2, 1)
    x = jnp.asarray(inputs["halo_x"]).transpose(0, 2, 1)
    refs["halo"] = np.asarray(jax.lax.conv_general_dilated(
        x, jnp.asarray(inputs["halo_w"]).transpose(2, 1, 0), (1,), "SAME",
        dimension_numbers=("NHC", "HIO", "NHC"))).transpose(0, 2, 1)

    jm = jmodels.ConvolutionalVQVAE(**SP_CFG)
    for name in ("sp_fwd", "sp_long"):
        loss, recon, perp = jm.apply({"params": jax_params[name]}, jnp.asarray(inputs[name]["x"]), train=False)
        refs[name] = (float(loss), np.asarray(recon), float(perp))
    xg = jnp.asarray(inputs["sp_grad"]["x"])

    def loss_rep(params):
        vq_loss, recon, _ = jm.apply({"params": params}, xg, train=False)
        return jnp.mean((recon - xg) ** 2) + vq_loss

    loss, grads = jax.value_and_grad(loss_rep)(jax.tree_util.tree_map(jnp.asarray, jax_params["sp_grad"]))
    refs["sp_grad"] = (float(loss), _np(grads))

    jcfg = _jax_cfg(SMALL_CFG)
    refs["speech_eval"] = _jax_step(jtrain.SpeechVQVAETask(config=jcfg, width_scale=WS, batch_size=B,
                                                           sequence_axis="seq"),
                                    jax_params["speech"], inputs["speech_batch"], dict(data=2, seq=1))[0]
    refs["echoed_eval"] = _jax_step(jtrain.EchoedSpeechTask(config=jcfg, width_scale=WS, batch_size=B,
                                                            sequence_axis="seq"),
                                    jax_params["echoed"], inputs["echoed_batch"], dict(data=2, seq=1))[0]
    refs["long"] = _jax_step(jtrain.EchoedSpeechTask(config=_jax_cfg(LONG_CFG), width_scale=WS, batch_size=2,
                                                     sequence_axis="seq"),
                             jax_params["long"], inputs["long_batch"], dict(data=1, seq=1))[0]
    refs["finetune_grads"] = _jax_finetune_grads(jax_params["echoed"], inputs["echoed_batch"])

    saved = jjitter.jitter, jjitter.jitter_sharded, jloop.sample_without_replacement
    jjitter.jitter = _fixed_jax_jitter
    jjitter.jitter_sharded = lambda x, key, p, axis_name, per_batch=False: _fixed_jax_jitter(x, key, p)
    jloop.sample_without_replacement = lambda key, n, k: jnp.arange(k)
    try:
        refs["mp"] = _jax_step(jtrain.SpeechVQVAETask(config=jcfg, width_scale=MP_WS, batch_size=B),
                               jax_params["mp"], inputs["mp_batch"], dict(data=2), train=True)
        # the speech stage's train step on make_mesh(data=2, seq=1), its sharded jitter (the whole sequence
        # on one shard) replaying the fixed decisions
        refs["speech_train"] = _jax_step(jtrain.SpeechVQVAETask(config=jcfg, width_scale=WS, batch_size=B,
                                                                sequence_axis="seq"),
                                         jax_params["speech"], inputs["speech_batch"], dict(data=2, seq=1),
                                         train=True)
    finally:
        jjitter.jitter, jjitter.jitter_sharded, jloop.sample_without_replacement = saved
    return refs


def _port_single(inputs, root):
    """The port's single-process references, and the single-process store
    the model = 4 ranks resume."""
    port_jitter = importlib.import_module("acoustic_locating_vq_vae_torch.ops.jitter")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' count: the convolutions sum in the same order
    refs = {}
    model = _sp_model()
    model.load_state_dict(inputs["sp_train"]["weights"])
    refs["sp_train"] = _sp_grads(model, torch.from_numpy(inputs["sp_train"]["x"]),
                                 generator=torch.Generator().manual_seed(TRAIN_GEN), train=True)
    saved = port_jitter.jitter_decisions
    port_jitter.jitter_decisions = _fixed_decisions
    try:
        tr = Trainer(_mp_task(), device="cpu", seed=0, verbose=False)
        tr.load_state_dict(inputs["mp"])
        refs["mp"] = dict(metrics=tr.step(_torch_batch(inputs["mp_batch"])),
                          **_f64_step(Trainer(_mp_task(), device="cpu", seed=0, verbose=False), inputs))
    finally:
        port_jitter.jitter_decisions = saved
    store_task = _mp_task(batch_size=4, ckpt_every=2, num_updates=4, eval_every=1000)
    whole = Trainer(store_task, device="cpu", seed=5, verbose=False)
    whole.fit(_torch_batch(inputs["store_batch"]), None)
    refs["store_whole"] = whole.state_dict()
    torch.set_num_threads(threads)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, compute the JAX and single-process references
    while they run, and return ``(ranks' results, port refs, JAX refs, root)``."""
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import models as jmodels
    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_torch.eval import params_from_jax

    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    inputs = {"conv_x": f32(2, 5, 64), "conv_w1": (f32(7, 5, 1), f32(7)), "conv_w3": (f32(7, 5, 3), f32(7)),
              "halo_x": f32(1, 3, 80), "halo_w": f32(3, 3, 3)}
    jax_params = {}
    jm = jmodels.ConvolutionalVQVAE(**SP_CFG)
    for seed, (name, length, b) in enumerate((("sp_fwd", 64, 2), ("sp_grad", 32, 2), ("sp_long", 4000, 1),
                                              ("sp_train", 64, 2))):
        x = f32(b, 5, length)
        p, sd = _vqvae_weights(jm, _sp_model(), x, 2, seed + 1)
        jax_params[name] = p
        inputs[name] = {"x": x, "weights": sd}
    jcfg = _jax_cfg(SMALL_CFG)
    f, t = SMALL_CFG.num_freq, SMALL_CFG.num_frames
    inputs["speech_batch"] = _batch(B, f, t, 20)
    inputs["fit_batch"] = _batch(16, f, t, 21)
    inputs["echoed_batch"] = _batch(B, f, t, 22)
    inputs["mp_batch"] = _batch(B, f, t, 23)
    inputs["store_batch"] = _batch(8, f, 16, 24)
    inputs["long_batch"] = _batch(2, LONG_CFG.num_freq, LONG_CFG.num_frames, 25)
    xs = _speech_task().model_inputs(_torch_batch(inputs["speech_batch"]))[0].numpy()
    jax_params["speech"], inputs["speech"] = _vqvae_weights(
        jtrain.SpeechVQVAETask(config=jcfg, width_scale=WS, compat_vq_flatten=False).build_model(),
        _speech_task().build_model(), xs, 3, 30)
    xm = _mp_task().model_inputs(_torch_batch(inputs["mp_batch"]))[0].numpy()
    jax_params["mp"], inputs["mp"] = _vqvae_weights(
        jtrain.SpeechVQVAETask(config=jcfg, width_scale=MP_WS).build_model(), _mp_task().build_model(), xm, 3, 31)
    jax_params["echoed"], inputs["echoed"] = _composite_weights(SMALL_CFG, 40)
    jax_params["long"], inputs["long"] = _composite_weights(LONG_CFG, 50)
    inputs["linear"] = {"w": f32(6, 4), "x": f32(16, 6), "y": f32(16, 4)}
    torch.save(inputs, root / "inputs.pt")
    # the single-process store the model = 4 ranks resume: two of its four updates
    store_task = _mp_task(batch_size=4, ckpt_every=2, num_updates=4, eval_every=1000)
    Trainer(store_task, device="cpu", seed=5, verbose=False, checkpoint_dir=str(root / "store_single")).fit(
        _torch_batch(inputs["store_batch"]), None, num_updates=2)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1] / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    cli_env = dict(env, OMP_NUM_THREADS="1")
    clis = {name: subprocess.Popen(_cli_argv(root / f"cli_{name}", name), env=cli_env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True) for name in CLI_RUNS}
    procs += list(clis.values())
    try:
        jax_refs = _jax_refs(inputs, jax_params)
        port_refs = _port_single(inputs, root)
        # a linear model's Adam step on the whole batch, in JAX (the sliced mesh's reference)
        import optax

        lin = inputs["linear"]
        params = {"w": jnp.asarray(lin["w"])}
        loss_fn = lambda p: jnp.mean((jnp.asarray(lin["x"]) @ p["w"] - jnp.asarray(lin["y"])) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(params)
        opt = optax.adam(1e-2)
        upd, _ = opt.update(g, opt.init(params), params)
        jax_refs["sliced"] = (float(loss), np.asarray(optax.apply_updates(params, upd)["w"]))
        jax_refs["params"] = {k: params_from_jax(v, 2) for k, v in jax_params.items() if k.startswith("sp_")}
        logs = [p.communicate(timeout=600)[0] for p in procs]
        cli = {name: [(p.returncode, log)] for (name, p), log in zip(clis.items(), logs[WORLD:])}
        resumes = {name: subprocess.Popen(_cli_argv(root / f"cli_{name}", name, "--resume"), env=cli_env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                   for name in CLI_RUNS}
        procs += list(resumes.values())
        for name, p in resumes.items():
            cli[name].append((p.returncode if p.wait(timeout=600) is not None else None, p.communicate()[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}" for r, (p, log) in
              enumerate(zip(procs[:WORLD], logs[:WORLD])) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    got = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    jax_refs["cli"] = cli
    return got, port_refs, jax_refs, root


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _rel(a, b) -> float:
    """``||a - b|| / ||b||`` in float64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float((a - b).norm())


def _grads_close(got, want, what=""):
    """Every gradient within rtol 1e-5 of the single process's, its entries
    also within GRAD_ATOL_SHARE of its largest."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, g in want.items():
        _close(got[k], g, SP_RTOL, GRAD_ATOL_SHARE * float(g.abs().max()), what=f"{what} {k}")


def _seq_shards(got, key, index=None):
    """The ranks' time shards of ``key`` laid end to end (rank r holds shard r on the seq = 4 mesh)."""
    parts = [g[key] if index is None else g[key][index] for g in got]
    return torch.cat([torch.as_tensor(p) for p in parts], dim=-1).numpy()


# ------------------------------------------------------- tests/test_sequence_parallel.py


@pytest.mark.parametrize("k", [1, 3])
def test_sharded_conv_matches_unsharded(runs, k):
    """The halo-exchange conv over 4 time shards equals JAX's unsharded SAME
    conv on every rank."""
    got, _, jax_refs, _ = runs
    for r in range(WORLD):
        _close(got[r][f"conv{k}"], jax_refs[f"conv{k}"], what=f"rank {r}")


def test_sharded_conv_rejects_indivisible_length():
    from acoustic_locating_vq_vae_torch.parallel import sequence_sharded_conv

    mesh = DataParallel(None, 0, 1, torch.device("cpu"), seq_rank=0, seq_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        sequence_sharded_conv(torch.ones(1, 4, 30), torch.ones(4, 4, 3), mesh)


def test_halo_is_only_cross_device_traffic(runs):
    """A sharded 3-tap conv over 4 ranks is seamless at every shard boundary,
    and its one collective is the halo exchange with its neighbours (point to
    point under gloo on CPU tensors)."""
    got, _, jax_refs, _ = runs
    _close(_seq_shards(got, "halo_out"), jax_refs["halo"])
    seq_group = tuple(range(WORLD))
    for r in range(WORLD):
        assert got[r]["halo_traffic"] == [("batch_isend_irecv", seq_group)], got[r]["halo_traffic"]


def test_param_partition_rules():
    """The JAX rules on the port's names and torch layouts."""
    # the 3-tap conv (out, in, k): column-parallel on large out
    assert param_partition_spec("_encoder._conv_1.weight", (1024, 201, 3), 2) == ("model", None, None)
    # a residual block's 1x1 conv_2: row-parallel on large in
    assert param_partition_spec("_encoder._residual_stack._layers.0._block.3.weight", (1024, 1024, 1), 2) == (
        None, "model", None)
    # the codebook (K, D): rows
    assert param_partition_spec("_vq._embedding.weight", (1024, 128), 2) == ("model", None)
    # small tensors and biases stay whole
    assert param_partition_spec("_pre_vq_conv.weight", (16, 16, 3), 2) == ()
    assert param_partition_spec("_encoder._conv_1.bias", (1024,), 2) == ()
    # a dense (out, in): the large input dim
    assert param_partition_spec("fc_1.weight", (1024, 205824), 2) == (None, "model")
    # indivisible dims stay whole; a transposed conv's out-features are its dim 1
    assert param_partition_spec("_encoder._conv_1.weight", (1023, 201, 3), 2) == ()
    assert param_partition_spec("_decoder._conv_trans_1.weight", (1024, 1024, 3), 2) == (None, "model", None)


def test_model_sequence_parallel_forward_matches_replicated(runs):
    """The SP model with time sharded over 4 ranks: (vq_loss, recon,
    perplexity) equal JAX's replicated model in eval mode."""
    got, _, jax_refs, _ = runs
    loss, recon, perp = jax_refs["sp_fwd"]
    for r in range(WORLD):
        _close(got[r]["sp_fwd"][0], loss, 1e-5, 0.0)
        _close(got[r]["sp_fwd"][2], perp, 1e-5, 0.0)
    _close(_seq_shards(got, "sp_fwd", 1), recon)


def test_model_sequence_parallel_gradients_match_replicated(runs):
    """Every parameter's gradient, averaged over the 4 time shards, equals
    JAX's replicated gradient (rtol 1e-4 / atol 1e-6, JAX's own test's)."""
    from acoustic_locating_vq_vae_torch.eval import params_from_jax

    got, _, jax_refs, _ = runs
    loss, grads = jax_refs["sp_grad"]
    want = params_from_jax(grads, 2)
    for r in range(WORLD):
        g_loss, g = got[r]["sp_grad"]
        _close(g_loss, loss, 1e-5, 0.0)
        for k, v in g.items():
            _close(v, want[k], 1e-4, 1e-6, what=k)


def test_model_sequence_parallel_long_sequence(runs):
    """4,000 frames, 8x the reference's 500-frame cut, over 4 ranks equal the
    replicated model."""
    got, _, jax_refs, _ = runs
    loss, recon, _ = jax_refs["sp_long"]
    _close(got[0]["sp_long"][0], loss, 1e-5, 0.0)
    _close(_seq_shards(got, "sp_long", 1), recon)


def test_model_sequence_parallel_training_step(runs):
    """A training step's loss and gradients with jitter on, over 4 time
    shards, equal the single process's on the same jitter draw: finite, and
    the gradients move every parameter."""
    got, port_refs, _, _ = runs
    loss, grads = port_refs["sp_train"]
    for r in range(WORLD):
        g_loss, g = got[r]["sp_train"]
        assert np.isfinite(g_loss)
        _close(g_loss, loss, SP_RTOL, 0.0)
        _grads_close(g, grads)
    assert all(float(v.abs().max()) > 0 for v in got[0]["sp_train"][1].values())


def test_jitter_sharded_semantics_across_boundaries(runs):
    """Every jittered position is itself or a true neighbour, also across
    the shards' edges, the global ends clamp inward, and the 4 shards are
    bitwise the unsharded jitter of the same draw."""
    from acoustic_locating_vq_vae_torch.ops.jitter import jitter, jitter_decisions

    got, _, _, _ = runs
    out = _seq_shards(got, "jitter")[0, 0]
    pos = np.arange(64)
    assert ((out == pos) | (out == pos - 1) | (out == pos + 1)).all()
    assert out[0] in (0.0, 1.0) and out[-1] in (63.0, 62.0)
    assert (out != pos).any()
    x = torch.arange(64, dtype=torch.float32)[None, None, :].expand(1, 3, 64)
    want = jitter(x, *jitter_decisions((64,), 0.5, torch.Generator().manual_seed(0)))
    assert np.array_equal(_seq_shards(got, "jitter"), want.numpy())


def test_trainer_sequence_parallel_speech_stage(runs):
    """SpeechVQVAETask(sequence_axis="seq") on (data = 2, seq = 2): 30
    updates from the trainer's fit, finite, the recon falling, and the store's
    metadata the resolved vectors flatten."""
    from acoustic_locating_vq_vae_torch.utils import StageStore

    got, _, _, root = runs
    f = got[0]["speech_fit"]
    assert np.isfinite(f["train"]["loss"]).all() and len(f["train"]["loss"]) == 30
    assert np.mean(f["train"]["recon_error"][-10:]) < np.mean(f["train"]["recon_error"][:10])
    assert StageStore(str(root / "speech_store")).stage_metadata("speech")["compat_vq_flatten"] is False
    for r in range(1, WORLD):
        np.testing.assert_array_equal(got[r]["speech_fit"]["train"]["loss"], f["train"]["loss"])


def test_trainer_sequence_parallel_matches_degenerate_seq(runs):
    """Eval-step metrics on (data = 2, seq = 2) equal JAX's Trainer on
    make_mesh(data=2, seq=1) with the same weights and batch."""
    got, _, jax_refs, _ = runs
    want = jax_refs["speech_eval"]
    for r in range(WORLD):
        assert set(got[r]["speech_eval"]) == set(want)
        for k, v in want.items():
            _close(got[r]["speech_eval"][k], v, RTOL, 0.0, what=k)


def test_trainer_sequence_parallel_train_step_matches_jax(runs):
    """A train step on (data = 2, seq = 2), jitter on with fixed decisions:
    every metric and every weight after Adam equal JAX's Trainer step on
    make_mesh(data=2, seq=1) with the same weights, batch and decisions."""
    from acoustic_locating_vq_vae_torch.eval import params_from_jax

    got, _, jax_refs, _ = runs
    metrics, params = jax_refs["speech_train"]
    want = params_from_jax(params, 3)
    for r in range(WORLD):
        m, state = got[r]["speech_train"]
        for k, v in metrics.items():
            _close(m[k], v, RTOL, 0.0, what=k)
        for k, w in want.items():
            _close(state[k], w, RTOL, ATOL, what=k)


def test_rir_task_rejects_sequence_axis():
    from acoustic_locating_vq_vae_torch.train import RirVQVAETask

    with pytest.raises(ValueError, match="sequence parallelism"):
        RirVQVAETask(sequence_axis="seq").build_model()


def test_explicit_compat_flatten_with_sequence_axis_raises():
    """An explicit compat flatten is never overridden; None resolves to the
    vectors flatten."""
    from acoustic_locating_vq_vae_torch.train.tasks import resolved_vq_flatten

    cfg = SMALL_CFG
    with pytest.raises(ValueError, match="compat_vq_flatten"):
        SpeechVQVAETask(config=cfg, width_scale=WS, sequence_axis="seq", compat_vq_flatten=True).build_model()
    auto = SpeechVQVAETask(config=cfg, width_scale=WS, sequence_axis="seq")
    assert resolved_vq_flatten(auto) is False and auto.build_model().compat_vq_flatten is False


def test_trainer_sequence_parallel_echoed_matches_degenerate_seq(runs):
    """The echoed composite on (data = 2, seq = 2), speech branch and decoder
    time-sharded and the RIR branch gathered: eval metrics equal JAX's on
    make_mesh(data=2, seq=1)."""
    got, _, jax_refs, _ = runs
    want = jax_refs["echoed_eval"]
    for r in range(WORLD):
        assert set(got[r]["echoed_eval"]) == set(want)
        for k, v in want.items():
            _close(got[r]["echoed_eval"][k], v, RTOL, 0.0, what=k)


def test_trainer_sequence_parallel_echoed_trains(runs):
    """The composite's fit on (data = 2, seq = 2), sharded jitter on: 20
    updates, finite, the recon falling, the same history on every rank."""
    got, _, _, _ = runs
    f = got[0]["echoed_fit"]
    assert np.isfinite(f["train"]["loss"]).all()
    assert np.mean(f["train"]["recon_error"][-5:]) < np.mean(f["train"]["recon_error"][:5])
    for r in range(1, WORLD):
        np.testing.assert_array_equal(got[r]["echoed_fit"]["train"]["loss"], f["train"]["loss"])


def test_finetune_sequence_parallel_grads_match_degenerate_seq(runs):
    """The finetune stage (encoders trained, anchor 0.25) on (data = 2,
    seq = 2): every gradient equals JAX's on make_mesh(data=2, seq=1),
    the encoder's through the RIR branch's gather included (rtol 2e-4 /
    atol 1e-6, JAX's own test's); the port's frozen parameters, which get no
    gradient, have JAX's zero."""
    from acoustic_locating_vq_vae_torch.eval import composite_params_from_jax

    got, _, jax_refs, _ = runs
    want = composite_params_from_jax(jax_refs["finetune_grads"])
    speech_max = max(float(v.abs().max()) for k, v in got[0]["finetune_grads"].items() if k.startswith("speech_model"))
    assert speech_max > 0.0
    for r in range(WORLD):
        g = got[r]["finetune_grads"]
        for k, w in want.items():
            if k in g:
                _close(g[k], w, 2e-4, 1e-6, what=k)
            else:
                assert not w.any(), k


def test_sequence_parallel_long_composite(runs):
    """A 2,000-frame echoed composite over 4 time shards: eval metrics equal
    JAX's replicated composite."""
    got, _, jax_refs, _ = runs
    for k, v in jax_refs["long"].items():
        _close(got[0]["long"][k], v, RTOL, 0.0, what=k)


def test_joint_task_rejects_sequence_axis():
    from acoustic_locating_vq_vae_torch.train import JointLocationTask

    with pytest.raises(ValueError, match="sequence parallelism"):
        JointLocationTask(sequence_axis="seq").build_model()


def test_composite_model_rejects_mismatched_branch_axes():
    """The composite checks its branches: the speech branch must share the
    axis, the RIR branch must not carry it."""
    from acoustic_locating_vq_vae_torch.models import EchoedSpeechReconModel
    from acoustic_locating_vq_vae_torch.train.tasks import rir_model, speech_model

    kw = dict(out_channels=33, num_hiddens=8, num_residual_layers=1, num_residual_hiddens=8)
    rir = rir_model(SMALL_CFG, WS, False)
    with pytest.raises(ValueError, match="speech_model"):
        EchoedSpeechReconModel(rir, speech_model(SMALL_CFG, WS, False), sequence_axis="seq", **kw)
    with pytest.raises(ValueError, match="rir_model"):
        from acoustic_locating_vq_vae_torch.models import ConvolutionalVQVAE

        bad_rir = ConvolutionalVQVAE(in_channels=100, num_hiddens=8, embedding_dim=4, num_residual_layers=1,
                                     num_residual_hiddens=4, commitment_cost=0.25, num_embeddings=8,
                                     compat_vq_flatten=False, sequence_axis="seq")
        EchoedSpeechReconModel(bad_rir, speech_model(SMALL_CFG, WS, False, sequence_axis="seq"),
                               sequence_axis="seq", **kw)


# ------------------------------------------------------- tests/test_dp_collectives.py:89-176


def test_model_parallel_step_matches_replicated(runs):
    """One train step on (data = 2, model = 2) with model_parallel equals the
    replicated step: its metrics JAX's (rtol 2e-4, JAX's own test's) and the
    port's single process's (rtol 1e-5); in float64 every gradient and every
    weight after Adam the single process's within rtol 1e-10. (In float32 the
    gradients of the decoder's residual convs lie up to 2e-4 (relative L2)
    from the single process's: the split convs sum in another order and a
    ReLU input at the rounding floor takes the other side.) Each rank holds
    half of every split parameter."""
    got, port_refs, jax_refs, _ = runs
    jax_metrics, _ = jax_refs["mp"]
    want = port_refs["mp"]
    for r in range(WORLD):
        res = got[r]["mp"]
        assert set(res["metrics"]) == set(jax_metrics)
        for k, v in jax_metrics.items():
            _close(res["metrics"][k], v, 2e-4, 0.0, what=k)
            _close(res["metrics"][k], want["metrics"][k], SP_RTOL, 0.0, what=k)
        assert set(res["grads"]) == set(want["grads"])
        for key in ("grads", "state"):
            for k, w in want[key].items():
                assert res[key][k].dtype == torch.float64
                _close(res[key][k], w, 1e-10, 1e-12 * float(w.abs().max()), what=f"{key} {k}")
    full = dict(_mp_task().build_model().named_parameters())
    local = got[0]["mp"]["local"]
    assert local["_vq._embedding.weight"] * 2 == full["_vq._embedding.weight"].numel()
    assert local["_encoder._conv_1.weight"] * 2 == full["_encoder._conv_1.weight"].numel()
    assert local["_encoder._conv_1.bias"] == full["_encoder._conv_1.bias"].numel()


def test_model_axis_collectives_present(runs):
    """The (data = 2, model = 2) step runs collectives over the model axis's
    pairs {0, 1} and {2, 3} (the split convs and codebook) and over the data
    axis's {0, 2} and {1, 3} (gradients and metrics)."""
    got, _, _, _ = runs
    for r in range(WORLD):
        groups = [g for _, g in got[r]["mp"]["collectives"]]
        model_pair = (0, 1) if r < 2 else (2, 3)
        data_pair = (0, 2) if r % 2 == 0 else (1, 3)
        assert groups.count(model_pair) >= 1 and groups.count(data_pair) >= 1, groups


def test_multislice_collective_groups_are_slice_contiguous(runs):
    """(data = 2, model = 2) on two fake nodes, rank r on node r % 2 (the
    worst case for a naive grouping): every model-axis collective's group
    lies within one node, the data axis's groups are node-contiguous (data
    coordinate d on node d), and the step's numbers are the plain mesh's."""
    got, _, _, _ = runs
    node = {r: r % 2 for r in range(WORLD)}
    for r in range(WORLD):
        res = got[r]["multislice"]
        data_line, model_line, _ = res["lines"]
        assert len({node[x] for x in model_line}) == 1
        assert [node[x] for x in data_line] == [0, 1]
        model_groups = {g for _, g in res["collectives"] if set(g) == set(model_line)}
        assert model_groups and all(len({node[x] for x in g}) == 1 for g in model_groups)
        assert any(set(g) == set(data_line) for _, g in res["collectives"])
        for k, v in res["metrics"].items():
            _close(v, got[0]["mp"]["metrics"][k], SP_RTOL, 0.0, what=k)


# ------------------------------------------------------- tests/test_multislice.py


def _interleaved(n=8, slices=2):
    return {r: r % slices for r in range(n)}


def test_slice_major_data_axis_and_in_slice_model_pairs():
    smap = _interleaved()
    grid = mesh_layout(8, model=2, slices=2, slice_map=smap)
    assert grid.shape == (4, 2, 1)
    for row in grid.reshape(4, 2):
        assert smap[int(row[0])] == smap[int(row[1])]
    assert [smap[int(r[0])] for r in grid.reshape(4, 2)] == [0, 0, 1, 1]


def test_callable_slice_map_and_no_topology_fallback():
    assert mesh_layout(8, slices=2, slice_map=lambda r: r % 2).shape == (8, 1, 1)
    assert mesh_layout(8, slices=4).ravel().tolist() == list(range(8))  # contiguous chunks


def test_model_axis_straddling_a_slice_is_rejected():
    with pytest.raises(ValueError, match="straddle"):
        mesh_layout(8, model=8, slices=2)


def test_unequal_slice_assignment_is_rejected():
    with pytest.raises(ValueError, match="equal"):
        mesh_layout(8, slices=2, slice_map={r: (0 if r < 3 else 1) for r in range(8)})
    with pytest.raises(ValueError, match="divisible"):
        mesh_layout(8, slices=3)


def test_partial_mesh_draws_evenly_from_every_slice():
    smap = _interleaved()
    grid = mesh_layout(8, data=4, slices=2, slice_map=smap)
    assert grid.shape == (4, 1, 1)
    assert [smap[int(r)] for r in grid.ravel()] == [0, 0, 1, 1]
    grid = mesh_layout(8, data=2, model=2, slices=2, slice_map=smap).reshape(2, 2)
    assert [smap[int(r[0])] for r in grid] == [0, 1]
    for row in grid:
        assert smap[int(row[0])] == smap[int(row[1])]
    with pytest.raises(ValueError, match="data=3 not divisible"):
        mesh_layout(8, data=3, slices=2, slice_map=smap)


def test_sliced_mesh_step_matches_single_device(runs):
    """A data = 4 mesh on two fake nodes (rank r on node r % 2, reordered
    node-major): one Adam step of a linear model equals optax's on the whole
    batch (rtol 1e-5 / atol 1e-6, JAX's own test's)."""
    got, _, jax_refs, _ = runs
    loss, w = jax_refs["sliced"]
    for r in range(WORLD):
        metrics, got_w, lines, d = got[r]["sliced"]
        assert lines[0] == (0, 2, 1, 3) and d == lines[0].index(r)
        _close(got_w, w, 1e-5, 1e-6)
        _close(metrics["loss"], loss, 1e-5, 0.0)


# ------------------------------------------------------- the port's own


@pytest.mark.parametrize("shards", [2, 4])
def test_cross_shard_tie_merge_is_the_unsplit_argmin(shards):
    """The plain version over 2 and 4 codebook blocks merged by score, then
    by global index, gives the unsplit ids bitwise: on random rows, on every
    code duplicated in another block, on +-0.0 scores and on pairs of codes
    1e-7 to 1e-5 apart."""
    from acoustic_locating_vq_vae_torch.ops import vq

    rng = np.random.default_rng(shards)
    k, d, n = 256, 32, 512
    cases = {}
    cb = rng.standard_normal((k, d)).astype(np.float32)
    cases["random"] = (rng.standard_normal((n, d)).astype(np.float32), cb)
    half = rng.standard_normal((k // 2, d)).astype(np.float32)
    cases["duplicated"] = (rng.standard_normal((n, d)).astype(np.float32), np.concatenate([half, half]))
    zero = cb.copy() + 3.0
    zero[3] = 0.0
    zero[k - 7] = 0.0
    cases["zeros"] = (np.zeros((n, d), np.float32), zero)
    near = cb.copy()
    for i, eps in enumerate((1e-7, 1e-6, 1e-5)):
        near[k - 1 - i] = near[i] * (1 + eps)
    cases["near ties"] = (np.concatenate([near[:3] * 0.999, rng.standard_normal((n - 3, d))]).astype(np.float32),
                          near)
    for label, (x, cb) in cases.items():
        x, cb = torch.from_numpy(x), torch.from_numpy(cb)
        want_ids, want_scores = vq.vq_nearest_scored(x, cb)
        assert torch.equal(want_ids, vq.vq_nearest(x, cb)), label
        block = k // shards
        scores, ids = [], []
        for s in range(shards):
            i, sc = vq.vq_nearest_scored(x, cb[s * block:(s + 1) * block])
            scores.append(sc)
            ids.append(i.long() + s * block)
        score, idx = vq.merge_nearest(torch.stack(scores), torch.stack(ids))
        assert torch.equal(idx.to(torch.int32), want_ids), label
        assert torch.equal(score, want_scores), label
    assert int(vq.vq_nearest(torch.zeros(1, d), torch.from_numpy(zero))[0]) == 3


@pytest.mark.parametrize("k,d", [(300, 129), (100, 64), (1024, 6)])
def test_code_norms_do_not_depend_on_the_split(k, d):
    """A code's squared norm, and so the scored operator's winning score, is
    bitwise the same in every row block of the codebook it is part of (K /
    blocks not a multiple of 4 and odd widths included), and within 1e-6 of
    the float64 norm."""
    from acoustic_locating_vq_vae_torch.ops import vq

    rng = np.random.default_rng(k + d)
    cb = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    norms = vq.code_norms(cb)
    want = (cb.double() ** 2).sum(1)
    assert float(((norms.double() - want).abs() / want).max()) < 1e-6
    ids, scores = vq.vq_nearest_scored(x, cb)
    for shards in (2, 4):
        block = k // shards
        for s in range(shards):
            part = cb[s * block:(s + 1) * block]
            assert torch.equal(vq.code_norms(part), norms[s * block:(s + 1) * block]), (shards, s)
            i, sc = vq.vq_nearest_scored(x, part)
            here = (ids.long() >= s * block) & (ids.long() < (s + 1) * block)
            assert torch.equal(sc[here], scores[here]), (shards, s)
            assert torch.equal(i[here].long() + s * block, ids[here].long()), (shards, s)


def test_default_backend_follows_the_node_layout():
    """NCCL where every rank on the node has its own card; gloo on the CPU
    and where the node's ranks share a card (a named index, or more ranks
    than cards), which NCCL refuses."""
    from acoustic_locating_vq_vae_torch.parallel.mesh import default_backend

    cpu, card, card0 = torch.device("cpu"), torch.device("cuda"), torch.device("cuda", 0)
    assert default_backend(cpu, 1, 0) == "gloo"
    assert default_backend(cpu, 4, 8) == "gloo"
    assert default_backend(card, 1, 1) == "nccl"
    assert default_backend(card, 8, 8) == "nccl"
    assert default_backend(card0, 1, 1) == "nccl"
    assert default_backend(card0, 2, 1) == "gloo"
    assert default_backend(card0, 2, 8) == "gloo"
    assert default_backend(card, 2, 1) == "gloo"


def test_partition_decisions_equal_jax_at_full_width():
    """param_partition_spec on the port's names and layouts gives JAX's
    decisions (carried across by ``partition_specs_from_jax``) for every
    parameter of every task at full width, on model axes of 2 and 4."""
    import jax
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu import train as jtrain
    from acoustic_locating_vq_vae_tpu.parallel.sharding_rules import param_partition_spec as jax_spec
    from acoustic_locating_vq_vae_torch.eval import partition_specs_from_jax
    from acoustic_locating_vq_vae_torch.train import make_task

    cfg = DatasetConfig()
    f, t = cfg.num_freq, cfg.num_frames
    inputs = {"speech": (jnp.zeros((1, f, 16)),), "rir": (jnp.zeros((1, 16, f)),),
              "echoed": (jnp.zeros((1, f, 16)), jnp.zeros((1, t, f))), "location_joint": (jnp.zeros((1, t, f)),)}
    inputs["finetune"] = inputs["echoed"]
    for name, args in inputs.items():
        jtask = {"speech": jtrain.SpeechVQVAETask, "rir": jtrain.RirVQVAETask, "echoed": jtrain.EchoedSpeechTask,
                 "finetune": jtrain.EncoderFinetuneTask, "location_joint": jtrain.JointLocationTask}[name]()
        jm = jtask.build_model()
        shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "jitter": jax.random.PRNGKey(1)},
                                *args)["params"]
        with torch.device("meta"):
            port = make_task(name).build_model()
        port_params = {k: tuple(p.shape) for k, p in port.named_parameters(remove_duplicate=False)}
        for size in (2, 4):
            def spec(path, leaf):
                s = tuple(jax_spec(path, leaf.shape, size))
                return s + (None,) * (len(leaf.shape) - len(s))

            tree = jax.tree_util.tree_map_with_path(spec, shapes, is_leaf=lambda x: hasattr(x, "shape"))
            layers = 3 if name == "speech" else 2
            want = partition_specs_from_jax(tree, layers, composite=name in ("echoed", "finetune"))
            assert set(want) <= set(port_params), (name, set(want) - set(port_params))
            for k, w in want.items():
                assert param_partition_spec(k, port_params[k], size) == w, (name, size, k)
    # the location stage's head: fc_1 (205,824 x 1024) is split by its input features
    with torch.device("meta"):
        head = make_task("location").build_model()
    assert param_partition_spec("fc_1.weight", tuple(head.fc_1.weight.shape), 2) == (None, "model")


def test_store_resumes_across_model_axis_sizes(runs):
    """A store written by one process at two of four updates resumes on
    model = 4 (each rank its blocks of the whole tensors), and one written on
    model = 4 resumes in one process: both end at the uninterrupted
    single-process run's weights, each tensor within 1e-5 (relative L2: Adam
    moves an entry whose gradient sits at the rounding floor by up to lr, so a
    tensor is compared as a whole)."""
    got, port_refs, _, root = runs
    want = port_refs["store_whole"]
    assert got[0]["resumed_at_model4"] == 4
    task = _mp_task(batch_size=4, ckpt_every=2, num_updates=4, eval_every=1000)
    single = Trainer(task, device="cpu", seed=5, verbose=False, checkpoint_dir=str(root / "store_model4"))
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    single.fit(_torch_batch(inputs["store_batch"]), None, resume=True)
    assert single.step_count == 4
    for state in (got[0]["resumed_state"], single.state_dict()):
        assert set(state) == set(want)
        for k, w in want.items():
            assert _rel(state[k], w) <= SP_RTOL, (k, _rel(state[k], w))


def test_the_operator_alone_imports_no_parallel_module():
    """An exported artifact loads with the VQ operator's module imported
    alone: importing ``ops.vq`` in a fresh process imports no module of the
    port outside ``ops`` (the sharded layers import ``parallel`` when they
    run sharded)."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import acoustic_locating_vq_vae_torch.ops.vq; "
            "print(sorted(m for m in sys.modules if m.startswith('acoustic_locating_vq_vae_torch')))")
    out = subprocess.run([sys.executable, "-c", code, str(src)], capture_output=True, text=True, timeout=120, check=True)
    mods = eval(out.stdout.strip().splitlines()[-1])
    pkg = "acoustic_locating_vq_vae_torch"
    assert [m for m in mods if m not in (pkg, f"{pkg}.ops") and not m.startswith(f"{pkg}.ops.")] == []


# ------------------------------------------------------- the CLI under torchrun


STAGES = ("speech", "rir", "echoed", "finetune", "location")


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_pipeline_cli_under_torchrun_runs_and_resumes(runs, name):
    """``torchrun --nproc-per-node 2 -m ...cli.run_pipeline`` with
    ``--mesh-seq 2 --sequence-parallel`` (width 1/32) and with ``--mesh-model
    2 --model-parallel`` (width 1/4, the split layers' widths) on gloo at the
    smoke size: exit 0 with every stage's final in the store (whole tensors:
    the location head's fc_1 at its full shape), and a rerun with --resume
    skips every stage and exits 0."""
    from acoustic_locating_vq_vae_torch.utils import StageStore

    _, _, jax_refs, root = runs
    (rc, log), (rc_resume, log_resume) = jax_refs["cli"][name]
    assert rc == 0, log[-3000:]
    assert rc_resume == 0, log_resume[-3000:]
    assert all(f"stage {s!r} complete in store" in log_resume for s in STAGES), log_resume[-3000:]
    store = StageStore(str(root / f"cli_{name}"))
    for stage in STAGES:
        assert store.stage_metadata(stage)["final"]
    if name == "seq":
        assert store.stage_metadata("speech")["compat_vq_flatten"] is False
    else:
        head = store.load_stage("location")["model"]["fc_1.weight"]
        assert head.shape == (1024, SMALL_CFG.num_freq * 16)  # 33 bins x D = 64 / 4


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
