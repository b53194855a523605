"""The port's bf16 ``compute_dtype`` against the JAX package's on the CPU: each
conv layer, ``ResidualStack``, the encoder and the decoder against flax's
``dtype=jnp.bfloat16``; the speech and RIR tasks (gradient and EMA codebook)
against ``compute_dtype="bfloat16"``; the rules that keep the VQ and the
location head in float32. The composite and location stages, the trainer,
a bf16 stage's store, the pipeline and the CLI are in
``test_torch_bf16_stages.py``.

The criterion is scale-free and taken from the reference itself: on the same
weights (carried across by ``params_from_jax``) and numpy inputs, the port's
bf16 result lies at most ``HALF`` as far from JAX's bf16 result as JAX's bf16
lies from JAX's float32, for every output, loss and gradient. The distance is
``||a - b|| / ||b||`` over the whole tensor. The largest-entry distance cannot
tell a sound port from a wrong one: one element rounded across a bf16
boundary moves it by a whole ulp of that element, up to 2^-8 of the maximum,
which is bf16's own distance from float32 (readings below).

Three things of XLA-CPU are not semantics and are taken out of the reference:

* The reference is jitted with XLA's excess precision off (``NO_EXCESS``):
  flax's roundings op by op, as JAX's eager ops give them. With it on (XLA's
  default, and the JAX package's jitted steps), a fusion may keep float32
  intermediates where flax rounds to bf16.

* XLA-CPU sums a bf16 tensor with bf16 partial sums: a (3, 64, 201) bf16
  reduction lies 1.26e-2 of its max from the exact sum, where one rounding of
  the float32 sum lies 2.8e-3. A conv bias's gradient is such a sum of the
  conv output's bf16 cotangent. The port (as XLA on a GPU or a TPU) sums in
  float32 and rounds once, so JAX's bias gradients are rebuilt from JAX's own
  cotangents the same way (``jax_value_and_grad``: ``flax.linen``'s method
  interception adds a bf16 zero to every biased conv's output and reads its
  cotangent). Every other gradient is JAX's as it comes.
* Codes: the port's are its plain float32 VQ on its own float32-cast latent
  (the rule "Exactness"), and agree with JAX bf16's at least as often as JAX
  bf16's agree with JAX float32's. A latent that differs by one bf16 rounding
  can pick the other code at a near tie, and one row's other code moves the
  whole reconstruction, so the losses and gradients would compare across a
  jump. JAX's bf16 reference of a loss or gradient therefore feeds each
  quantizer the port's latent value straight through
  (``z + stop_gradient(z_port - z)``, by the same interception): the same
  codes, JAX's own computation before and after them. The latents themselves
  are compared without it.

Readings (port vs JAX bf16 / JAX bf16 vs JAX float32, at seeds 0, 1, 2,
width 1/32; recorded when the tests were written): every module's output
and gradient 0 (bitwise XLA-CPU's) / 2.1e-3 to 8.6e-3. The speech stage's
pre-VQ latent 0 / 4.6e-3, 5.9e-4 / 4.9e-3, 2.3e-4 / 5.1e-3; reconstruction
1.3e-7 / 5.8e-2, 1.7e-5 / 7.0e-2, 3.9e-7 / 4.0e-2; loss 2.4e-7 / 1.3e-3,
2.8e-7 / 6.7e-3, 2.8e-7 / 1.5e-3; the worst ratio over every output, loss
and gradient 0.056, 0.12, 0.055. The RIR stage's latent 4.5e-4 / 4.6e-3,
2.2e-4 / 4.6e-3, 4.2e-4 / 5.2e-3; loss 1.2e-7 / 4.5e-3, 1.9e-5 / 1.3e-2,
0 / 1.8e-3; worst ratio 0.099, 0.047, 0.081. The EMA modes read the same
ratios. With the bias fused into the conv (one rounding where flax rounds
twice) the modules fail the criterion (``test_fused_bias_fails_the_criterion``).
"""

import dataclasses
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acoustic_locating_vq_vae_tpu import models as jmodels
from acoustic_locating_vq_vae_tpu import ops as jops
from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_tpu.ops.vq import VectorQuantizer as JaxVectorQuantizer
from acoustic_locating_vq_vae_torch import ops as tops
from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.eval import params_from_jax
from acoustic_locating_vq_vae_torch.models import ConvolutionalEncoder, DeconvolutionalDecoder
from acoustic_locating_vq_vae_torch.ops import Conv1d, ConvTranspose1d, ResidualStack
from acoustic_locating_vq_vae_torch.train import JointLocationTask, LocationTask, RirVQVAETask, SpeechVQVAETask, make_task

BF16 = torch.bfloat16
HALF = 0.5
F32_REL = 1e-5  # float32 against float32, summed in another order (the float32 tests' rtol 1e-4 / atol 1e-5)
SEEDS = (0, 1, 2)
WS = 1 / 32
T_SPEECH = 64
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The widths here are tiny: torch's CPU convolutions spend milliseconds
    a call starting a pool of every core, and microseconds on four."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b) -> float:
    """``||a - b|| / ||b||`` in float64."""
    a, b = (np.asarray(torch.as_tensor(v).detach().double() if isinstance(v, torch.Tensor) else v, np.float64)
            for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_closer(port, j16, j32, what: str) -> float:
    """The criterion: the port's bf16 result within HALF of JAX bf16's own
    distance from JAX float32. Where JAX's bf16 result lies within float32
    rounding of its float32 one (F32_REL: a float32 head behind equal codes,
    the straight-through value's last bit), there is no bf16 distance to
    halve, and the port's must lie within F32_REL of it. Returns the ratio
    (0 in that case)."""
    got, ref = rel(port, j16), rel(j16, j32)
    if ref <= F32_REL:
        assert got <= F32_REL, f"{what}: port vs JAX bf16 {got:.3g}, which is JAX float32's within {ref:.3g}"
        return 0.0
    assert got <= HALF * ref, f"{what}: port vs JAX bf16 {got:.3g}, JAX bf16 vs float32 {ref:.3g}"
    return got / ref


def _biased_conv(ctx) -> bool:
    return isinstance(ctx.module, fnn.Conv) and ctx.method_name == "__call__" and ctx.module.use_bias


def _vq_call(ctx) -> bool:
    return isinstance(ctx.module, JaxVectorQuantizer) and ctx.method_name == "__call__"


_COMPILED = {}
# flax's bf16 semantics op by op: XLA's default lets a jitted fusion keep float32 intermediates where flax rounds
# to bf16 (a single conv's weight gradient moves by 2.7e-2 of its max); JAX's eager ops never do
NO_EXCESS = {"xla_allow_excess_precision": False}


def jax_value_and_grad(loss_fn, params, bf16: bool, vq_inputs=None, args=(), key=None):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``, jitted;
    with ``bf16``, each conv bias's gradient is JAX's cotangent of that conv's
    bf16 output summed in float64 and rounded to bf16 once instead of
    XLA-CPU's bf16 partial sums, and the quantizer at each module path of
    ``vq_inputs`` reads that value straight through (see the module
    docstring). Calls with the same ``key`` share one compiled function: their
    ``loss_fn`` may differ only in what comes in by ``params`` and ``args``."""
    params, args = jax.tree_util.tree_map(jnp.asarray, (params, args))
    vq_inputs = vq_inputs or {}
    paths = tuple(sorted(vq_inputs))
    cache_key = None if key is None else (key, bf16, paths)
    if cache_key not in _COMPILED or cache_key is None:
        if not bf16:
            _COMPILED[cache_key] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), compiler_options=NO_EXCESS), ()
        else:
            calls = []

            def record(next_fun, a, kw, ctx):
                y = next_fun(*a, **kw)
                if _biased_conv(ctx):
                    calls.append((ctx.module.path, y.shape, y.dtype))
                return y

            with fnn.intercept_methods(record):
                jax.eval_shape(loss_fn, params, *args)

            def perturbed(p, zeros, vq_values, *a):
                it, vq = iter(zeros), dict(zip(paths, vq_values))

                def add(next_fun, fa, kw, ctx):
                    if _vq_call(ctx) and ctx.module.path in vq:
                        z = fa[0]
                        fa = (z + jax.lax.stop_gradient(vq[ctx.module.path] - z),) + tuple(fa[1:])
                    y = next_fun(*fa, **kw)
                    return y + next(it) if _biased_conv(ctx) else y

                with fnn.intercept_methods(add):
                    return loss_fn(p, *a)

            _COMPILED[cache_key] = jax.jit(jax.value_and_grad(perturbed, argnums=(0, 1), has_aux=True), compiler_options=NO_EXCESS), tuple(calls)
    fn, calls = _COMPILED[cache_key]
    if not bf16:
        return fn(params, *args)
    zeros = [jnp.zeros(shape, dtype) for _, shape, dtype in calls]
    (value, aux), (grads, cts) = fn(params, zeros, [jnp.asarray(vq_inputs[k]) for k in paths], *args)
    grads = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), grads)
    sums = {}
    for (path, _, _), ct in zip(calls, cts):
        ct = np.asarray(ct, np.float64)
        total = ct.sum(axis=tuple(range(ct.ndim - 1))).astype(np.float32)
        sums[path] = sums.get(path, 0.0) + np.asarray(jnp.asarray(total, jnp.bfloat16), np.float32)
    for path, total in sums.items():  # the biases of the parameters differentiated; a frozen branch's are not
        node = grads
        for k in path:
            node = node.get(k, {}) if isinstance(node, dict) else {}
        if "bias" in node:
            node["bias"] = total
    return (value, aux), grads


def _x(b, c, length, seed):
    return np.random.default_rng(seed).standard_normal((b, c, length)).astype(np.float32)


def _batch(b, t, seed, f=201):
    """A numpy sample batch: non-negative spectrograms (B, f, t), angles and
    radii."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, f, t)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full((b,), 16000, np.int32),
        theta=rng.uniform(-3, 3, b).astype(np.float32), wiener_est=rng.exponential(1.0, (b, f)).astype(np.float32),
        radius=rng.uniform(0.5, 1.5, b).astype(np.float32),
    )


def jax_init(jm, x, seed, key):
    """``jm.init`` on ``x`` (an input or a tuple of inputs) with params and
    jitter keys from ``seed``, jitted, one compiled function per ``key``."""
    key = ("init",) + tuple(key)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(lambda rngs, a: jm.init(rngs, *a))
    rngs = {"params": jax.random.PRNGKey(seed), "jitter": jax.random.PRNGKey(seed + 1)}
    return _np(_COMPILED[key](rngs, x if isinstance(x, tuple) else (x,)))


def jax_codes(jm, variables, x, key, method="get_latent_codes"):
    """``jm.apply(variables, *x, method=...)`` (``x`` an input or a tuple of
    inputs) jitted as ``jax_value_and_grad`` is, one compiled function per
    ``key``."""
    key = ("codes",) + tuple(key)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(lambda v, a: jm.apply(v, *a, method=getattr(jm, method)), compiler_options=NO_EXCESS)
    return _np(_COMPILED[key](variables, x if isinstance(x, tuple) else (x,)))


def _jax_pre_vq_latent(m, x):
    """The JAX VQ-VAE's pre-VQ latent, channels-first and float32."""
    z = m._pre_vq_conv(m._encoder(jnp.swapaxes(x, -1, -2)))
    return jnp.swapaxes(z, 1, 2).astype(jnp.float32)


def port_vq_inputs(model, run):
    """{JAX module path: value} of what every quantizer of ``model`` reads
    while ``run()`` runs (numpy, float32)."""
    seen, hooks = {}, []
    for name, module in model.named_modules():
        if isinstance(module, tops.VectorQuantizer):
            path = tuple(name.split(".")) if name else ()
            hooks.append(module.register_forward_pre_hook(
                lambda m, args, path=path: seen.__setitem__(path, args[0].detach().numpy().copy())))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(v.dtype == np.float32 for v in seen.values())
    return seen


def jax_batch(d):
    return JaxSampleBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_batch(d):
    return SampleBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


# ---------------------------------------------------------------- modules


def _module_case(kind, seed, compute_dtype=BF16):
    """(JAX module in float32, the same in bf16, its channels-last input,
    params, the port's module on those weights in ``compute_dtype``, the
    port's (B, C, L) input, a map of JAX gradients to port names)."""
    c, length = 12, 30
    conv_sd = lambda k: torch.from_numpy(np.ascontiguousarray(k.transpose(2, 1, 0)))
    convt_sd = lambda k: torch.from_numpy(np.ascontiguousarray(k[::-1].transpose(1, 2, 0)))
    if kind in ("conv", "conv_transpose"):
        cls = jops.Conv1d if kind == "conv" else jops.ConvTranspose1d
        make = lambda dt: cls(9, dtype=dt)
        to_port = lambda p: {"weight": (conv_sd if kind == "conv" else convt_sd)(np.asarray(p["Conv_0"]["kernel"])),
                             "bias": torch.from_numpy(np.array(p["Conv_0"]["bias"]))}
        port = (Conv1d(c, 9, compute_dtype=compute_dtype) if kind == "conv"
                else ConvTranspose1d(c, 9, compute_dtype=compute_dtype))
    elif kind == "residual_stack":
        make = lambda dt: jops.ResidualStack(c, 2, 8, dtype=dt)
        prefix = "_residual_stack."

        def to_port(p):  # the encoder's layout of the same tree: its conv_1 unused
            sd = params_from_jax({"conv_1": {"Conv_0": {"kernel": np.zeros((3, 1, c))}}, "residual_stack": p})
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        port = ResidualStack(c, 2, 8, compute_dtype=compute_dtype)
    elif kind == "encoder":
        make = lambda dt: jmodels.ConvolutionalEncoder(16, 2, 8, dtype=dt)
        to_port = params_from_jax
        port = ConvolutionalEncoder(c, 16, 2, 8, compute_dtype=compute_dtype)
    else:
        make = lambda dt: jmodels.DeconvolutionalDecoder(out_channels=7, num_hiddens=16, num_residual_layers=3,
                                                         num_residual_hiddens=8, dtype=dt)
        to_port = lambda p: params_from_jax(p, num_residual_layers=3)
        port = DeconvolutionalDecoder(c, 7, 16, 3, 8, compute_dtype=compute_dtype)
    x = _x(2, c, length, 100 + seed)
    xl = jnp.asarray(x.transpose(0, 2, 1))
    j32, j16 = make(None), make(jnp.bfloat16)
    p = jax_init(j32, xl, seed, ("module", kind))["params"]
    port.load_state_dict(to_port(p))
    return j32, j16, xl, p, port, torch.from_numpy(x), to_port


def _module_run(kind, seed, compute_dtype=BF16):
    """Outputs and parameter gradients of sum(out * w) for a seeded
    cotangent w: JAX float32, JAX bf16 and the port's."""
    j32, j16, xl, p, port, x, to_port = _module_case(kind, seed, compute_dtype)
    kw = {"train": False} if kind == "decoder" else {}
    out_shape = jax.eval_shape(lambda v: j32.apply({"params": p}, v, **kw), xl).shape
    w = np.random.default_rng(200 + seed).standard_normal(out_shape).astype(np.float32)
    runs = {}
    for name, jm in (("f32", j32), ("bf16", j16)):
        def loss_fn(params, v, cot, jm=jm):
            out = jm.apply({"params": params}, v, **kw)
            return jnp.sum(out.astype(jnp.float32) * cot), out

        (_, out), grads = jax_value_and_grad(loss_fn, p, name == "bf16", args=(xl, w), key=("module", kind))
        runs[name] = (np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1), to_port(_np(grads)), str(out.dtype))
    out = port(x, **kw)
    (out.float() * torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))).sum().backward()
    grads = {k: prm.grad for k, prm in port.named_parameters()}
    return runs, out, grads, port


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["conv", "conv_transpose", "residual_stack", "encoder", "decoder"])
def test_module_matches_jax_bf16(kind, seed):
    """The output and every parameter gradient by the criterion; the output
    has JAX's dtype (bf16, the decoder's float32, JAX ``:110``; a stack fed
    float32 adds its float32 skip, as JAX promotes it), the parameters and
    their gradients are float32."""
    runs, out, grads, port = _module_run(kind, seed)
    assert out.dtype == {"bfloat16": BF16, "float32": torch.float32}[runs["bf16"][2]]
    assert out.dtype == (BF16 if kind in ("conv", "conv_transpose", "encoder") else torch.float32)
    assert all(prm.dtype == torch.float32 for prm in port.parameters())
    assert_closer(out.detach().float(), runs["bf16"][0], runs["f32"][0], f"{kind} output")
    assert set(grads) <= set(runs["bf16"][1])  # a tied block's parameters appear once
    for k, g in grads.items():
        assert g.dtype == torch.float32
        assert_closer(g, runs["bf16"][1][k], runs["f32"][1][k], f"{kind} gradient {k}")


def test_fused_bias_fails_the_criterion(monkeypatch):
    """The check bites: a conv that fuses the bias into a native bf16
    convolution (one rounding where flax rounds twice) breaks the criterion
    on the conv layers and the encoder at every seed."""
    from acoustic_locating_vq_vae_torch.ops import conv

    def fused(fn, x, weight, bias, padding, compute_dtype):
        if compute_dtype is None:
            return fn(x, weight, bias, padding=padding)
        b = None if bias is None else bias.to(compute_dtype)
        return fn(x.to(compute_dtype), weight.to(compute_dtype), b, padding=padding)

    monkeypatch.setattr(conv, "_conv", fused)
    for kind in ("conv", "conv_transpose", "encoder"):
        for seed in SEEDS:
            runs, out, _, _ = _module_run(kind, seed)
            assert rel(out.detach().float(), runs["bf16"][0]) > HALF * rel(runs["bf16"][0], runs["f32"][0]), (kind, seed)


@pytest.mark.parametrize("kind", ["conv", "conv_transpose"])
def test_float32_conv_is_the_fused_float32_conv(kind):
    """compute_dtype None is the float32 path as before: bitwise the plain
    float32 convolution with its bias fused."""
    _, _, _, _, port, x, _ = _module_case(kind, 0, None)
    fn = F.conv1d if kind == "conv" else F.conv_transpose1d
    out = port(x)
    assert out.dtype == torch.float32
    assert torch.equal(out, fn(x, port.weight, port.bias, padding=1))


# ---------------------------------------------------------------- the speech and RIR tasks


def _latent_codebook(model, x, seed):
    """K pre-VQ latent rows of ``x`` as the quantizer reads them (float32)."""
    with torch.no_grad():
        z = model.pre_vq_latent(x)
        rows = (z if model.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, model.embedding_dim)
    assert rows.dtype == torch.float32
    pick = np.random.default_rng(seed).choice(rows.shape[0], model.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _task_case(name, ema, seed):
    """(JAX tasks f32 and bf16, their models, params, vq_stats or None, the
    port's bf16 task and model on the same weights, frames, layers)."""
    jcls, tcls, t, layers = {
        "speech": (jtrain.SpeechVQVAETask, SpeechVQVAETask, T_SPEECH, 3),
        "rir": (jtrain.RirVQVAETask, RirVQVAETask, 500, 2),
    }[name]
    jtasks = {dt: jcls(width_scale=WS, vq_ema=ema, compute_dtype=dt) for dt in ("float32", "bfloat16")}
    jms = {dt: t_.build_model() for dt, t_ in jtasks.items()}
    (x0,) = jtasks["float32"].model_inputs(jax_batch(_batch(1, t, 300 + seed)))
    v = jax_init(jms["float32"], x0, seed, ("task", name, ema))
    p, stats = v["params"], v.get("vq_stats")
    task = tcls(width_scale=WS, vq_ema=ema, compute_dtype="bfloat16")
    model = task.build_model()
    model.load_state_dict(params_from_jax(p, layers, vq_stats=stats))
    (xs,) = task.model_inputs(torch_batch(_batch(2, t, 310 + seed)))
    cb = _latent_codebook(model, xs, 320 + seed)
    if ema:
        stats["_vq"]["codebook"] = cb
        stats["_vq"]["ema_sums"] = cb * 1.5
        stats["_vq"]["ema_counts"] = np.random.default_rng(seed).uniform(0.5, 2.0, cb.shape[0]).astype(np.float32)
    else:
        p["_vq"]["codebook"] = cb
    model.load_state_dict(params_from_jax(p, layers, vq_stats=stats))
    if ema:  # a training step without jitter decisions to match: the EMA update runs, the jitter does not
        jms = {dt: m.clone(use_jitter=False) for dt, m in jms.items()}
        model._decoder._jitter = None
    return jtasks, jms, p, stats, task, model, t, layers


def _codes_check(model, x, codes_port, codes_j16, codes_j32, what):
    """The exactness rule and the agreement rule (module docstring)."""
    with torch.no_grad():
        z = model.pre_vq_latent(x)
        flat = (z if model.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, model.embedding_dim)
        plain, _ = tops.nearest_codebook(flat, model._vq._embedding.weight)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(codes_port).reshape(-1), plain.numpy(), err_msg=what)
    agree_port = float(np.mean(np.asarray(codes_port).reshape(-1) == np.asarray(codes_j16).reshape(-1)))
    agree_jax = float(np.mean(np.asarray(codes_j16).reshape(-1) == np.asarray(codes_j32).reshape(-1)))
    assert agree_port >= agree_jax, f"{what}: codes agree with JAX bf16's {agree_port}, JAX's own {agree_jax}"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,ema", [("speech", False), ("rir", False), ("speech", True), ("rir", True)],
                         ids=["speech", "rir", "speech_ema", "rir_ema"])
def test_task_matches_jax_bf16(name, ema, seed):
    """Loss, metrics, every gradient, the codes and (EMA) the updated
    buffers, against JAX's ``compute_dtype="bfloat16"`` by the criterion.
    Gradient mode runs ``train=False``; EMA mode a training step (the
    update), the speech decoder's jitter off in both packages."""
    jtasks, jms, p, stats, task, model, t, layers = _task_case(name, ema, seed)
    d = _batch(3, t, 330 + seed)
    train = ema
    (x,) = task.model_inputs(torch_batch(d))
    vq_in = port_vq_inputs(model, lambda: model.get_latent_codes(x))
    runs = {}
    for dt, jt in jtasks.items():
        jm = jms[dt]
        variables = {"vq_stats": stats} if ema else None

        def loss_fn(params, batch, variables, jt=jt, jm=jm):
            loss, metrics = jt.loss(jm, params, batch, {}, train, variables=variables)
            (xj,) = jt.model_inputs(batch)
            v = {"params": params, **(variables or {})}
            latent = jm.apply(v, xj, method=_jax_pre_vq_latent)
            recon = jm.apply(v, xj, train=False, train_vq=False)[1]
            return loss, (metrics, latent, recon)

        (loss, (metrics, latent, recon)), grads = jax_value_and_grad(
            loss_fn, p, dt == "bfloat16", vq_in, (jax_batch(d), variables), key=("task", name, ema))
        (xj,) = jt.model_inputs(jax_batch(d))
        codes = jax_codes(jm, {"params": p, **({"vq_stats": stats} if ema else {})}, xj, ("task", name, ema, dt))
        new_stats = _np(metrics["_variables"]["vq_stats"]["_vq"]) if ema else None
        runs[dt] = (float(loss), metrics, params_from_jax(_np(grads), layers, vq_stats=stats), np.asarray(codes),
                    new_stats, np.asarray(latent), np.asarray(recon))
    r16, r32 = runs["bfloat16"], runs["float32"]
    with torch.no_grad():  # before the step moves an EMA codebook
        codes = model.get_latent_codes(x)
        latent = model.pre_vq_latent(x)
        recon = model(x, train=False, train_vq=False)[1]
    _codes_check(model, x, codes.numpy(), r16[3], r32[3], f"{name} codes")
    assert latent.dtype == torch.float32 and recon.dtype == torch.float32
    assert_closer(latent, r16[5], r32[5], "pre-VQ latent")
    assert_closer(recon, r16[6], r32[6], "reconstruction")
    model.train()
    loss, metrics = task.loss(model, torch_batch(d), train)
    loss.backward()
    assert loss.dtype == torch.float32 and all(v.dtype == torch.float32 for v in metrics.values())
    assert_closer(loss.item(), r16[0], r32[0], "loss")
    for k in ("recon_error", "vq_loss"):
        assert_closer(metrics[k].item(), float(r16[1][k]), float(r32[1][k]), k)
    for k, prm in model.named_parameters():
        assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32
        assert_closer(prm.grad, r16[2][k], r32[2][k], f"gradient {k}")
    if ema:
        vq = model._vq
        # equal code histograms (the codes check above), so counts within float32 rounding
        np.testing.assert_allclose(vq.ema_counts.numpy(), r16[4]["ema_counts"], rtol=1e-6)
        for key, got in (("ema_sums", vq.ema_sums), ("codebook", vq._embedding.weight)):
            assert_closer(got - torch.from_numpy(stats["_vq"][key]), r16[4][key] - stats["_vq"][key],
                          r32[4][key] - stats["_vq"][key], f"EMA {key} update")


# ---------------------------------------------------------------- float32 where JAX keeps it


def test_vq_distances_and_head_run_in_float32(monkeypatch):
    """Under bf16 tasks (speech, the frozen localizer, the joint localizer) the
    VQ's distance product and every Dense layer of the head get float32
    inputs, and convs bf16 ones: nothing turns the whole step to bf16."""
    from acoustic_locating_vq_vae_torch.ops import vq

    seen = {"nearest": [], "linear": [], "conv": []}
    nearest, linear, conv1d = vq.nearest_indices, F.linear, F.conv1d

    def spy(key, fn):
        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            seen[key].append(tuple(a.dtype for a in tensors))
            if key == "conv":  # the CPU form: float32 operands that bf16 holds exactly
                assert all(torch.equal(a, a.to(BF16).float()) for a in tensors)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(vq, "nearest_indices", spy("nearest", nearest))
    monkeypatch.setattr(F, "linear", spy("linear", linear))
    monkeypatch.setattr(F, "conv1d", spy("conv", conv1d))
    cfg = DatasetConfig(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
    d = torch_batch(_batch(2, cfg.num_frames, 400, f=cfg.num_freq))
    kw = dict(config=cfg, width_scale=WS, compute_dtype="bfloat16")
    speech = SpeechVQVAETask(**kw)
    speech.loss(speech.build_model(), d, True, torch.Generator().manual_seed(0))[0].backward()
    joint = JointLocationTask(predict_radius=True, **kw)
    joint.loss(joint.build_model(), d, True)[0].backward()
    loc = LocationTask(input_mode="quantized", **kw)
    rir = loc.build_frozen(loc.build_composite().state_dict(), torch.device("cpu"))
    loc.step_loss(loc.build_model(), rir, d, True)[0].backward()
    assert len(seen["nearest"]) == 3 and len(seen["linear"]) == 10
    for key in ("nearest", "linear"):
        assert all(dt == torch.float32 for call in seen[key] for dt in call), (key, seen[key])
    # the port's CPU convs take bf16-rounded operands in float32 (ops/conv.py)
    assert seen["conv"] and all(dt == torch.float32 for call in seen["conv"] for dt in call)


def test_no_autocast_on_the_path():
    """The port copies flax's per-layer dtype; it never turns on autocast,
    which would send the VQ's ``flat_x @ codebook.T`` and the head to bf16."""
    src = REPO / "src" / "acoustic_locating_vq_vae_torch"
    hits = [f"{p}:{i}" for p in src.rglob("*.py") for i, line in enumerate(p.read_text().splitlines(), 1)
            if "autocast" in line]
    assert not hits, hits
    assert "autocast" not in (REPO / "chip_smoke.py").read_text()


# ---------------------------------------------------------------- compute_dtype rules


TASKS = ("speech", "rir", "echoed", "finetune", "location", "location_joint")


@pytest.mark.parametrize("name", TASKS)
def test_compute_dtype_values(name):
    """float32 is the default; "bfloat16" builds bf16 convs over float32
    state-dict tensors; any other value raises, at construction."""
    assert make_task(name).compute_dtype == "float32"
    task = make_task(name, width_scale=WS, compute_dtype="bfloat16")
    # the frozen location stage's convs are its RIR branch's; its own model is the float32 head
    model = task.build_rir_model() if name == "location" else task.build_model()
    convs = [m for m in model.modules() if isinstance(m, (Conv1d, ConvTranspose1d))]
    assert convs and all(m.compute_dtype == BF16 for m in convs)
    sd = (task.build_composite() if name == "location" else model).state_dict()
    assert sd and all(v.dtype == torch.float32 for v in sd.values())
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="compute_dtype"):
            make_task(name, compute_dtype=bad)
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(task, compute_dtype="float64")
