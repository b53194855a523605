"""The port's spans (``utils/profiling.py:span``): where they appear in a
trace and how they nest, that they record nothing with no profiler running,
that they change no output, and that the exported localizer holds none.

One module-wide pass, at tiny widths on one CPU thread, runs two rounds of
a resident echoed step, a cached step, an on-the-fly batch and step, and a
served call, from fixed seeds: once with ``torch.profiler.record_function``
made to raise and no profiler running, and once under a profiler with the
benchmark's schedule (the first round warms up, the second is recorded),
each part inside an annotation of the test's own."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.eval import export_localizer, load_localizer, make_serving_fn
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, JointLocationTask, Trainer
from acoustic_locating_vq_vae_torch.utils import span

SMALL = DatasetConfig(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
WS = 1 / 32
SPANS = {"train.sample", "train.step", "train.backward", "train.otf_batch", "synth.rir", "synth.spectra",
         "vq.quantize", "vq.perplexity", "serve.call"}
PARTS = ("echoed", "cached", "otf", "serve")
# (span, the innermost span or part around it) -> how many in one recorded round
NESTING = {
    "echoed": {("train.sample", "echoed"): 1, ("train.step", "echoed"): 1, ("vq.quantize", "train.step"): 2,
               ("vq.perplexity", "vq.quantize"): 2, ("train.backward", "train.step"): 1},
    "cached": {("train.sample", "cached"): 1, ("train.step", "cached"): 1, ("vq.perplexity", "train.step"): 2,
               ("train.backward", "train.step"): 1},
    "otf": {("train.otf_batch", "otf"): 1, ("synth.rir", "train.otf_batch"): 1,
            ("synth.spectra", "train.otf_batch"): 1, ("train.step", "otf"): 1, ("vq.quantize", "train.step"): 2,
            ("vq.perplexity", "vq.quantize"): 2, ("train.backward", "train.step"): 1},
    "serve": {("serve.call", "serve"): 1, ("vq.quantize", "serve.call"): 1, ("vq.perplexity", "vq.quantize"): 1},
}


def _data(b: int, seed: int) -> SampleBatch:
    g = torch.Generator().manual_seed(seed)
    f, t = SMALL.num_freq, SMALL.num_frames
    spec = lambda: torch.empty(b, f, t).exponential_(generator=g)
    return SampleBatch(speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=torch.full((b,), 16000),
                       theta=torch.rand(b, generator=g), wiener_est=torch.rand(b, f, generator=g),
                       radius=torch.ones(b))


def _weights(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def _parts():
    """Each part as a callable of one round: (what the step or call
    returned, the trained weights after it), built from fixed seeds; and
    the joint task with its serving closure."""
    task = EchoedSpeechTask(config=SMALL, width_scale=WS, batch_size=4)
    data = _data(8, 1)
    echoed = Trainer(task, device="cpu", seed=3, verbose=False)
    cached = Trainer(task, device="cpu", seed=3, verbose=False, cache_frozen=True)
    cache = cached.build_cache(data)
    # one image-source RIR a batch (the reference's fixed-RIR ablation): the CPU's lattice walk is the slow part
    otf = Trainer(task, device="cpu", seed=3, verbose=False, on_the_fly=True, synth_kwargs={"fixed_rir": True})
    joint = JointLocationTask(config=SMALL, width_scale=WS)
    serve = make_serving_fn(joint, joint.build_model(torch.Generator().manual_seed(4)).state_dict(), SMALL,
                            device="cpu")
    x = _data(2, 5).echoed_spec

    def cached_step():
        batch, rows = cached.sample_cached(data, cache)
        return cached.step(batch, cache=rows), _weights(cached)

    calls = {
        "echoed": lambda: (echoed.step(echoed.sample(data)), _weights(echoed)),
        "cached": cached_step,
        "otf": lambda: (otf.step(otf.otf_batch()), _weights(otf)),
        "serve": lambda: (serve(x), []),
    }
    return calls, (joint, serve)


def _round(calls):
    out = {}
    for name in PARTS:
        with span(name):
            out[name] = calls[name]()
    return out


@pytest.fixture(scope="module")
def passes():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            def refuse(*args, **kwargs):
                raise AssertionError("a span called record_function with no profiler running")

            mp.setattr(torch.profiler, "record_function", refuse)
            calls, _ = _parts()
            plain = [_round(calls) for _ in range(2)]
        calls, served = _parts()
        with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
                as prof:
            warm = _round(calls)
            prof.step()
            recorded = _round(calls)
            prof.step()
        return {"plain": plain, "profiled": [warm, recorded], "events": prof.events(), "served": served}
    finally:
        torch.set_num_threads(saved)


def _innermost(e, names):
    parent = e.cpu_parent
    while parent is not None and parent.name not in names:
        parent = parent.cpu_parent
    return None if parent is None else parent.name


@pytest.mark.parametrize("part", PARTS)
def test_spans_nest_as_documented(passes, part):
    """The recorded round holds each part's spans, each inside the span the
    layer table of PERF.md puts it in, and nothing else of the program's."""
    names = SPANS | set(PARTS)
    host = [e for e in passes["events"] if e.device_type == torch.autograd.DeviceType.CPU]
    (top,) = [e for e in host if e.name == part]
    inside = lambda e: top.time_range.start <= e.time_range.start and e.time_range.end <= top.time_range.end
    got = collections.Counter((e.name, _innermost(e, names)) for e in host if e.name in SPANS and inside(e))
    assert dict(got) == NESTING[part]


def test_spans_record_only_while_a_profiler_records(passes):
    """Nothing of the warm-up round is recorded, and with no profiler
    running a span is the one shared no-op context (the plain pass ran with
    ``record_function`` made to raise)."""
    counts = collections.Counter(e.name for e in passes["events"] if e.name in set(PARTS))
    assert counts == {name: 1 for name in PARTS}
    assert span("train.step") is span("serve.call")
    with span("train.step") as inside:
        assert inside is None


@pytest.mark.parametrize("part", PARTS)
def test_outputs_bitwise_with_and_without_a_profiler(passes, part):
    """Both rounds of each part give bitwise the same outputs and weights
    with spans recorded as with spans off."""
    for plain, profiled in zip(passes["plain"], passes["profiled"]):
        (out_a, w_a), (out_b, w_b) = plain[part], profiled[part]
        flat = lambda out: list(out.values()) if isinstance(out, dict) else list(out)
        for a, b in zip(flat(out_a) + w_a, flat(out_b) + w_b):
            assert torch.equal(a, b)
        assert len(flat(out_a)) == len(flat(out_b)) > 0 and len(w_a) == len(w_b)


def test_exported_localizer_holds_no_profiler_op(passes, tmp_path):
    """``export_localizer`` traces ``localize``, outside ``serve.call``; the
    quantizer's spans are off while it traces, so the program has no
    profiler operation, and it answers as the closure does."""
    joint, serve = passes["served"]
    export_localizer(joint, None, SMALL, str(tmp_path), batch_size=2, device="cpu", serve_fn=serve)
    call, _ = load_localizer(str(tmp_path), device="cpu")
    targets = [str(n.target) for n in call.module.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    x = _data(2, 5).echoed_spec
    for a, b in zip(call(x), serve(x)):
        assert torch.equal(a, b)
