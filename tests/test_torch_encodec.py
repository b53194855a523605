"""The port's EnCodec (``models/encodec.py``, the residual quantizer of
``ops/vq.py``, the strided, causal and weight-normed convs of
``ops/conv.py``, ``CodecTask`` and ``eval/serving.py:make_codec_serving_fn``)
against the plain reference ``tests/encodec_reference.py``, and the
reference against transformers' ``EncodecModel`` where that package imports.

A tiny configuration of the published architecture: 4 filters, a 16-dim
latent, ratios [2, 2] (hop 4), 4 stages of 32 codes (``sampling_rate`` 4800,
so that 24 kbps is 4 stages), clips of a few hundred samples. Weights are
seeded: each ``weight_v`` kaiming-uniform and its ``weight_g`` its norm, and
each codebook 32 rows of the residual the earlier stages leave of a separate
seeded batch (random codebooks make the assignment a lottery of near ties).
"""

import ast
import math
import os
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "port_bench"))

import encodec_reference as R  # noqa: E402

from acoustic_locating_vq_vae_torch.eval.serving import make_codec_serving_fn  # noqa: E402
from acoustic_locating_vq_vae_torch.models.encodec import EncodecModel  # noqa: E402
from acoustic_locating_vq_vae_torch.ops import vq  # noqa: E402
from acoustic_locating_vq_vae_torch.ops.conv import Conv1d, ConvTranspose1d  # noqa: E402
from acoustic_locating_vq_vae_torch.train.tasks import make_task  # noqa: E402

TINY = dict(R.CONFIG, sampling_rate=4800, num_filters=4, hidden_size=16, upsampling_ratios=[2, 2], codebook_size=32)
TASK_KW = dict(sampling_rate=4800, num_filters=4, hidden_size=16, upsampling_ratios=(2, 2), codebook_size=32)
# float32 against float64 on these sizes: the worst gaps read 2e-7 (latent) and 4e-7 (audio) of their peaks;
# the limit leaves 50x for other seeds and BLAS orders, and lies 100x under one ulp of bf16 (TF32: 5e-4)
F32_RTOL = 2e-5
# a near tie: the port's code's float64 squared distance within this share of ||r||^2 + ||e||^2 of the best
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _params(seed=0):
    """Seeded weights under the published keys (see the module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    p = {}
    for k, v in make_task("codec", **TASK_KW).build_model().state_dict().items():
        if k.endswith("weight_v"):
            p[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * math.sqrt(6.0 / v[0].numel())
        else:
            p[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * 0.1
    for k in [k for k in p if k.endswith("weight_g")]:
        p[k] = torch.linalg.vector_norm(p[k[:-1] + "v"], dim=(1, 2), keepdim=True)
    audio = torch.randn(8, 400, generator=gen) * 0.1
    with torch.no_grad():
        z = R.encoder(p, audio[:, None], TINY)
    residual = z.transpose(1, 2).reshape(-1, z.shape[1])
    for i in range(R.num_quantizers(TINY)):
        pick = torch.randperm(residual.shape[0], generator=gen)[: TINY["codebook_size"]]
        embed = residual[pick].clone()
        p[f"quantizer.layers.{i}.codebook.embed"] = embed
        residual = residual - embed[R.nearest(residual, embed)]
    return p


@pytest.fixture(scope="module")
def params():
    return _params()


def _port(p, dtype=torch.float32) -> EncodecModel:
    model = make_task("codec", **TASK_KW).build_model().to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in p.items()})
    return model.eval()


def _near_ties_only(p, z, got, want):
    """Every code where ``got`` (B, n_q, T) differs from the reference's
    ``want`` is a near tie in float64 along ``got``'s own residuals."""
    residual = z.double().transpose(1, 2).reshape(-1, z.shape[1])
    pd = {k: v.double() for k, v in p.items()}
    for i in range(got.shape[1]):
        e = pd[f"quantizer.layers.{i}.codebook.embed"]
        g = got[:, i].reshape(-1).long()
        d2 = (residual[:, None, :] - e[None]).pow(2).sum(-1)
        best = d2.min(dim=1)
        gap = (d2.gather(1, g[:, None])[:, 0] - best.values) / (residual.pow(2).sum(1) + e[best.indices].pow(2).sum(1))
        assert bool((gap[g != best.indices] < NEAR_TIE).all()), (i, gap.max())
        residual = residual - e[g]
    return int((got != want).sum())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_against_the_reference_stage_by_stage(params, dtype):
    """The encoder's latent, the codes of every stage and the decoded audio
    from the same codes: float64 equal to the reference's float64 (codes
    exactly, values to 1e-12 of their peak: only the order of sums differs);
    float32 within ``F32_RTOL`` of float64, its codes the reference's
    wherever the two best distances are not a near tie."""
    x = torch.randn(3, 301, generator=torch.Generator().manual_seed(1)) * 0.1
    p64 = {k: v.double() for k, v in params.items()}
    with torch.no_grad():
        z_ref = R.encoder(p64, x.double()[:, None], TINY)
        codes_ref = R.rvq_encode(p64, z_ref, 4).transpose(0, 1)  # (B, n_q, T)
        model = _port(params, dtype)
        z = model._run(model.encoder.layers, x.to(dtype)[:, None])
        codes = model.encode(x.to(dtype)[:, None], 4)
        audio = model.decode(codes, 301)[:, 0]
        audio_ref = R.serve(p64, x.double(), TINY, codes=codes.long())[1]
    rtol = 1e-12 if dtype == torch.float64 else F32_RTOL
    assert (z.double() - z_ref).abs().max() <= rtol * z_ref.abs().max()
    assert (audio.double() - audio_ref).abs().max() <= rtol * audio_ref.abs().max()
    assert codes.shape == codes_ref.shape == (3, 4, math.ceil(301 / 4))
    if dtype == torch.float64:
        assert torch.equal(codes.long(), codes_ref)
    else:
        _near_ties_only(params, z_ref, codes, codes_ref)


@pytest.mark.parametrize("length", [4, 9, 257, 301])
def test_output_length_equals_input_length(params, length):
    """Lengths that are not a multiple of the hop (the extra right padding,
    the transposed convs' trim, the final cut), down to one frame, whose
    convs pad more than the input holds (reflect's zero guard)."""
    x = torch.randn(2, length, generator=torch.Generator().manual_seed(length)) * 0.1
    model = _port(params, torch.float64)
    with torch.no_grad():
        codes, audio = model(x.double())
        want_codes, want = R.serve({k: v.double() for k, v in params.items()}, x.double(), TINY)
    assert audio.shape == x.shape and codes.shape == (2, 4, math.ceil(length / 4))
    assert torch.equal(codes.long(), want_codes)
    assert (audio - want).abs().max() <= 1e-12 * want.abs().max()


def test_an_exact_tie_goes_to_the_first_index():
    """Duplicated codebook rows: the port (the vq_nearest operator) and the
    reference (EnCodec's ``max`` over ``-dist``) both take the first."""
    gen = torch.Generator().manual_seed(3)
    rows = torch.randn(4, 8, generator=gen)
    book = torch.cat([rows, rows, rows[:2]])  # rows 0-3 again at 4-7 and 0-1 at 8-9
    x = rows[[3, 1, 0, 2]] + 0.01 * torch.randn(4, 8, generator=gen)
    assert vq.residual_codes(x, [book])[0].tolist() == [3, 1, 0, 2]
    assert R.nearest(x, book).tolist() == [3, 1, 0, 2]
    zero = torch.zeros(2, 8)
    assert vq.residual_codes(zero, [torch.zeros(5, 8)])[0].tolist() == [0, 0]


def test_served_call_through_serving_equals_the_reference(params):
    serve = make_codec_serving_fn(make_task("codec", **TASK_KW), params, device="cpu")
    x = torch.randn(3, 300, generator=torch.Generator().manual_seed(5)) * 0.1
    before = vq.residual_codes.stages
    codes, audio = serve(x)
    assert vq.residual_codes.stages - before == 4 and serve.num_quantizers == 4
    want_codes, want = R.serve(params, x, TINY)
    assert codes.dtype == torch.int32 and codes.shape == (3, 4, 75) and audio.shape == (3, 300)
    p64 = {k: v.double() for k, v in params.items()}
    with torch.no_grad():
        z = R.encoder(p64, x.double()[:, None], TINY)
    _near_ties_only(params, z, codes, want_codes)
    from_codes = R.serve(p64, x.double(), TINY, codes=codes.long())[1]
    assert (audio.double() - from_codes).abs().max() <= F32_RTOL * from_codes.abs().max()
    # fewer stages at a lower bandwidth: 6 kbps at 5 bits and 1,200 frames/s is 1 stage
    one = make_codec_serving_fn(make_task("codec", bandwidth=6.0, **TASK_KW), params, device="cpu")
    assert one.num_quantizers == 1 and torch.equal(one(x)[0], codes[:, :1])


def test_spans_of_a_served_call(params):
    """``serve.call`` holds the codec's four spans once each, side by side,
    and neither the quantizer's loss path (``vq.quantize``) nor its
    ``bincount`` read-back (``vq.perplexity``)."""
    from torch.profiler import ProfilerActivity, profile

    serve = make_codec_serving_fn(make_task("codec", **TASK_KW), params, device="cpu")
    x = torch.randn(2, 64)
    serve(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(x)
    names = {"serve.call", "codec.encode", "rvq.encode", "rvq.decode", "codec.decode", "vq.quantize", "vq.perplexity"}

    def around(e):
        parent = e.cpu_parent
        while parent is not None and parent.name not in names:
            parent = parent.cpu_parent
        return None if parent is None else parent.name

    got = sorted((e.name, around(e)) for e in prof.events() if e.name in names)
    assert got == sorted([("serve.call", None)] + [(n, "serve.call") for n in
                                                   ("codec.encode", "rvq.encode", "rvq.decode", "codec.decode")])


PUBLISHED = {  # facebook/encodec_24khz: a few entries of its checkpoint, the key count and the weight count
    "encoder.layers.0.conv.weight_v": (32, 1, 7), "encoder.layers.3.conv.weight_v": (64, 32, 4),
    "encoder.layers.12.conv.weight_v": (512, 256, 16), "encoder.layers.13.lstm.weight_ih_l1": (2048, 512),
    "encoder.layers.15.conv.weight_g": (128, 1, 1), "decoder.layers.3.conv.weight_v": (512, 256, 16),
    "decoder.layers.4.block.1.conv.weight_v": (128, 256, 3), "decoder.layers.15.conv.weight_v": (1, 32, 7),
    "quantizer.layers.31.codebook.embed": (1024, 128), "quantizer.layers.0.codebook.inited": (1,),
}


def test_state_dict_is_the_published_layout():
    model = make_task("codec").build_model()
    sd = model.state_dict()
    assert all(tuple(sd[k].shape) == s for k, s in PUBLISHED.items())
    assert len(sd) == 252 and sum(v.numel() for v in sd.values()) == 23_273_218
    assert model.num_quantizers == 32
    assert [model.quantizers_for_bandwidth(b) for b in (1.5, 3.0, 6.0, 12.0, 24.0)] == [2, 4, 8, 16, 32]
    with pytest.raises(NotImplementedError):
        make_task("codec").loss(None, None, True)


def test_benchmark_reference_copy_equals_the_tests_reference(params):
    """``port_bench/reference/encodec.py`` is a copy of this reference: the
    same numbers, bitwise, in float64."""
    from reference import encodec as B

    p = {k: v.double() for k, v in params.items()}
    x = torch.randn(2, 299, generator=torch.Generator().manual_seed(7)).double()[:, None] * 0.1
    with torch.no_grad():
        z, zb = R.encoder(p, x, TINY), B.encoder(p, x, TINY)
        codes, codes_b = R.rvq_encode(p, z, 4).transpose(0, 1), B.rvq_encode(p, zb, 4)
        assert torch.equal(z, zb) and torch.equal(codes, codes_b)
        assert torch.equal(R.decoder(p, R.rvq_decode(p, codes.transpose(0, 1)), TINY),
                           B.decoder(p, B.rvq_decode(p, codes_b), TINY))
        assert B.judge_codes(p, z, codes, 1e-9) == (0, 0, 0.0)
        wrong = codes.clone()
        wrong[0, 3, 3] = (wrong[0, 3, 3] + 1) % 32  # the last stage: no later residual moves
        assert B.judge_codes(p, z, wrong, 1e-9)[:2] == (1, 1)


def test_stride_one_convs_run_the_calls_they_ran_before():
    """The options added for the codec leave the VQ-VAE's stride-1 convs
    bitwise as the plain torch calls they were, bf16 included."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 37, generator=gen)
    conv, convt = Conv1d(6, 5, 3, padding=1, generator=gen), ConvTranspose1d(6, 5, 3, padding=1, generator=gen)
    assert torch.equal(conv(x), F.conv1d(x, conv.weight, conv.bias, padding=1))
    assert torch.equal(convt(x), F.conv_transpose1d(x, convt.weight, convt.bias, padding=1))
    bf = Conv1d(6, 5, 3, padding=1, generator=gen, compute_dtype=torch.bfloat16)
    want = F.conv1d(x.bfloat16().float(), bf.weight.bfloat16().float(), padding=1).bfloat16() + bf.bias.bfloat16()[:, None]
    assert torch.equal(bf(x), want)


def test_strided_or_causal_convs_on_a_sequence_axis_are_refused():
    """A time shard's halo is a stride-1 SAME conv's: anything else on a
    sequence axis raises at construction instead of computing wrong."""
    for kw in (dict(stride=2), dict(dilation=2), dict(padding="causal")):
        with pytest.raises(ValueError, match="stride-1 SAME"):
            Conv1d(4, 4, 3, sequence_axis="seq", **{"padding": 1, **kw})
    with pytest.raises(ValueError, match="stride-1 SAME"):
        ConvTranspose1d(4, 4, 4, padding="causal", stride=2, sequence_axis="seq")
    Conv1d(4, 4, 3, padding=1, sequence_axis="seq")  # the stride-1 SAME conv still is one


def test_weight_norm_folds_at_load():
    """``weight`` is g * v / ||v||, refolded whenever a state dict is loaded,
    and not itself in the state dict."""
    conv = Conv1d(3, 4, 5, padding="causal", weight_norm=True)
    assert set(conv.state_dict()) == {"weight_g", "weight_v", "bias"}
    sd = {k: v * 2 if k == "weight_g" else v for k, v in conv.state_dict().items()}
    conv.load_state_dict(sd)
    v = sd["weight_v"]
    assert torch.allclose(conv.weight, sd["weight_g"] * v / v.norm(dim=(1, 2), keepdim=True), rtol=1e-6)


def test_echoed_waveform_is_the_one_the_spectrograms_are_made_of():
    """``echoed_from_draws`` gives the waveform ``synthesize_from_draws``
    makes its echoed spectrogram of, at a sample rate other than 16 kHz."""
    from acoustic_locating_vq_vae_torch.data import DatasetConfig, draw_synthesis, echoed_from_draws
    from acoustic_locating_vq_vae_torch.data.synth import observed_power_spec, synthesize_from_draws

    cfg = DatasetConfig(fs=24000, n_sample=768, NFFT=600, HOP_LENGTH=240, num_frames=20, audio_samples=4800)
    draws = draw_synthesis(torch.Generator().manual_seed(4), 2, cfg)
    wave = echoed_from_draws(draws, cfg)
    assert wave.shape == (2, 4800)
    assert torch.equal(observed_power_spec(wave, cfg), synthesize_from_draws(draws, cfg).echoed_spec)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_codec_path_imports_no_jax_and_no_transformers():
    paths = [REPO / "src/acoustic_locating_vq_vae_torch" / p for p in
             ("models/encodec.py", "ops/vq.py", "ops/conv.py", "train/tasks.py", "eval/serving.py")]
    paths += [REPO / "tests/encodec_reference.py", REPO / "port_bench/reference/encodec.py",
              REPO / "port_bench/configs/encodec_24khz.py", REPO / "port_bench/loops/codec_serve.py"]
    for path in paths:
        assert not set(_imports(path)) & {"jax", "flax", "acoustic_locating_vq_vae_tpu", "transformers"}, path


@pytest.fixture(scope="module")
def transformers_model(params):
    """transformers' EncodecModel at the tiny configuration with the same weights."""
    os.environ.setdefault("USE_TF", "0")
    modeling = pytest.importorskip("transformers.models.encodec.modeling_encodec")
    from transformers.models.encodec.configuration_encodec import EncodecConfig

    model = modeling.EncodecModel(EncodecConfig(**{k: TINY[k] for k in R.CONFIG})).eval()
    named = lambda k: k.replace("parametrizations.weight.original0", "weight_g").replace(
        "parametrizations.weight.original1", "weight_v")
    full = {**params, **{f"quantizer.layers.{i}.codebook.{b}": torch.zeros_like(v) for i in range(4)
                         for b, v in (("cluster_size", params["quantizer.layers.0.codebook.cluster_size"]),
                                      ("embed_avg", params["quantizer.layers.0.codebook.embed"]))}}
    model.load_state_dict({k: full[named(k)] for k in model.state_dict()})
    return model, {named(k) for k in model.state_dict()}


def test_reference_equals_transformers(params, transformers_model):
    """The reference against the published code at the same configuration
    and weights: the same state-dict keys, the same codes, and audio within
    float32's rounding (weight norm and the LSTM are computed in another
    order)."""
    model, keys = transformers_model
    assert keys == set(make_task("codec", **TASK_KW).build_model().state_dict())
    x = torch.randn(3, 301, generator=torch.Generator().manual_seed(6)) * 0.1
    with torch.no_grad():
        out = model(x[:, None], bandwidth=24.0)
        codes, audio = R.serve(params, x, TINY)
    assert torch.equal(out.audio_codes[0], codes)
    want = out.audio_values[:, 0]
    assert (audio - want).abs().max() <= F32_RTOL * want.abs().max()


def test_lstm_reader_counts_each_kernel_once():
    """The profiler puts a kernel cuDNN's RNN launches under the operator
    and again under the runtime call inside it: the reader of
    ``lstm_share.codec`` takes the runtime calls' time off once."""
    from harness import cell

    read = cell.load_part(cell.load_benchmark(), "metrics", "lstm_share.codec").read
    ops = [("aten::lstm", 0.7, ("codec.encode", "serve.call")), ("aten::_cudnn_rnn", 0.7, ("aten::lstm", "codec.encode")),
           ("cudaLaunchKernel", 0.25, ("aten::_cudnn_rnn", "aten::lstm")),
           ("cudaMemsetAsync", 0.05, ("aten::_cudnn_rnn", "aten::lstm")),
           ("cudaLaunchKernel", 0.2, ("aten::add", "serve.call"))]
    assert read({"trace": {"busy_s": 1.0, "host_ops": ops}}) == pytest.approx(40.0)
    assert read({"trace": {"busy_s": 1.0, "host_ops": ops[-1:]}}) is None
    assert read({"trace": None}) is None
