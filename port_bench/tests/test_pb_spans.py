"""The span summary of a traced window (``harness/spans.py``) on a made-up
list of profiler events, the readers of the program's spans, and the span
table of a tiny run on the CPU.

The events (µs): on the main thread ``bench.window`` [0, 100] holds
``serve.call`` [10, 60], which holds ``vq.quantize`` [20, 40] and its
``aten::bincount`` [25, 35] with a ``cudaStreamSynchronize`` [28, 34];
launches at 12 and 45 under ``serve.call``, a ``cudaMemcpy`` at 75 and a
``cudaDeviceSynchronize`` at 95 under ``bench.window``. On a second thread
``bench.other`` [70, 90] and a launch at 50 with no parent (as autograd's
thread launches). Kernels [13, 22], [46, 55], [60, 65], [92, 94]; the
device's side of ``serve.call`` and a ``ProfilerStep#1`` are left out."""

from types import SimpleNamespace

import pytest
import torch
from conftest import TINY_SEED, tiny
from torch.autograd import DeviceType

from harness import cell, spans, trace

US = 1e-6


def _event(name, start, end, thread=1, device=False, annotation=False, parent=None, device_us=0.0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), thread=thread,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, is_user_annotation=annotation,
                           cpu_parent=parent, device_time_total=device_us)


def _events(program_spans=True):
    """The module docstring's events; without ``program_spans`` the
    program's annotations are left out (as a program without spans gives),
    their operations hung on ``bench.window``."""
    step = _event("ProfilerStep#1", -5, 105, annotation=True)
    window = _event("bench.window", 0, 100, annotation=True, parent=step, device_us=25.0)
    call = _event("serve.call", 10, 60, annotation=True, parent=window, device_us=18.0) if program_spans else window
    quantize = _event("vq.quantize", 20, 40, annotation=True, parent=call, device_us=0.0) if program_spans else call
    bincount = _event("aten::bincount", 25, 35, parent=quantize)
    events = [step, window, bincount,
              _event("cudaStreamSynchronize", 28, 34, parent=bincount),
              _event("cudaMemcpyAsync", 30, 31, parent=bincount),
              _event("cudaLaunchKernel", 12, 13, parent=call),
              _event("cudaLaunchKernel", 45, 46, parent=call),
              _event("cudaMemcpy", 75, 76, parent=window),
              _event("cudaDeviceSynchronize", 95, 99, parent=window),
              _event("bench.other", 70, 90, thread=2, annotation=True),
              _event("cudaLaunchKernel", 50, 51, thread=2),
              _event("serve.call", 13, 55, device=True, annotation=True)]
    events += [_event(f"kernel_{i}", a, b, device=True) for i, (a, b) in enumerate([(13, 22), (46, 55), (60, 65),
                                                                                     (92, 94)])]
    if program_spans:
        events += [call, quantize]
    return events


def test_idle_is_cut_at_span_boundaries_and_sums_to_the_window():
    s = spans.summarise(_events())
    assert set(s) == {"bench.window", "serve.call", "vq.quantize", "bench.other"}
    self_idle = {name: v["self_idle_s"] / US for name, v in s.items()}
    assert self_idle == pytest.approx({"bench.window": 23.0, "serve.call": 14.0, "vq.quantize": 18.0,
                                       "bench.other": 20.0})
    assert sum(self_idle.values()) == pytest.approx(100.0 - 25.0)  # the window less the kernels' union
    idle = {name: v["idle_s"] / US for name, v in s.items()}
    assert idle == pytest.approx({"bench.window": 75.0, "serve.call": 32.0, "vq.quantize": 18.0, "bench.other": 20.0})


def test_self_time_against_inclusive_time():
    s = spans.summarise(_events())
    host = {name: (v["host_s"] / US, v["self_host_s"] / US) for name, v in s.items()}
    # bench.other lies on another thread: it is no child of bench.window
    assert host == {"bench.window": pytest.approx((100.0, 50.0)), "serve.call": pytest.approx((50.0, 30.0)),
                    "vq.quantize": pytest.approx((20.0, 20.0)), "bench.other": pytest.approx((20.0, 20.0))}
    assert {name: v["device_s"] / US for name, v in s.items()} == pytest.approx(
        {"bench.window": 25.0, "serve.call": 18.0, "vq.quantize": 0.0, "bench.other": 0.0})
    assert {name: v["count"] for name, v in s.items()} == {"bench.window": 1, "serve.call": 1, "vq.quantize": 1,
                                                           "bench.other": 1}


def test_launches_and_syncs_are_counted_by_time_across_threads():
    s = spans.summarise(_events())
    calls = {name: (v["launches"], v["syncs"]) for name, v in s.items()}
    # the other thread's launch at 50 counts for serve.call, the main thread's copy at 75 for bench.other
    assert calls == {"bench.window": (3, 3), "serve.call": (3, 1), "vq.quantize": (0, 1), "bench.other": (0, 1)}
    assert [n for n in ("cudaLaunchKernelExC_v11060", "cuLaunchKernel", "cudaGraphLaunch") if spans.is_launch(n)] \
        == ["cudaLaunchKernelExC_v11060", "cuLaunchKernel", "cudaGraphLaunch"]
    assert [n for n in ("cudaMemcpyAsync", "cudaMemcpy", "cudaEventSynchronize") if spans.is_sync(n)] \
        == ["cudaMemcpy", "cudaEventSynchronize"]


def test_a_window_without_its_annotation_summarises_to_nothing():
    assert spans.summarise([e for e in _events() if e.name != "bench.window"]) == {}


def test_the_trace_summary_keeps_its_keys_and_values():
    """``harness/trace.py:summarise`` of these events: the values its
    readers read, as the benchmark's first version computed them."""
    t = trace.summarise(_events())
    assert set(t) == {"busy_s", "window_s", "device_ops", "idle_gaps", "kernels", "host_ops"}
    assert t["busy_s"] == pytest.approx(25 * US) and t["window_s"] == pytest.approx(100 * US)
    assert t["device_ops"] == [["kernel_0", pytest.approx(9 * US)], ["kernel_1", pytest.approx(9 * US)],
                               ["kernel_2", pytest.approx(5 * US)], ["kernel_3", pytest.approx(2 * US)]]
    assert t["idle_gaps"] == [["bench.other", pytest.approx(27 * US)], ["aten::bincount", pytest.approx(24 * US)],
                              ["python between ops", pytest.approx(13 * US)],
                              ["cudaDeviceSynchronize", pytest.approx(6 * US)], ["serve.call", pytest.approx(5 * US)]]
    assert t["kernels"] == [("kernel_0", pytest.approx(9 * US)), ("kernel_1", pytest.approx(9 * US)),
                            ("kernel_2", pytest.approx(5 * US)), ("kernel_3", pytest.approx(2 * US))]
    outer = ("bench.window", "ProfilerStep#1")
    assert t["host_ops"] == [
        ("bench.window", pytest.approx(25 * US), ("ProfilerStep#1",)),
        ("aten::bincount", 0.0, ("vq.quantize", "serve.call") + outer),
        ("cudaStreamSynchronize", 0.0, ("aten::bincount", "vq.quantize", "serve.call") + outer),
        ("cudaMemcpyAsync", 0.0, ("aten::bincount", "vq.quantize", "serve.call") + outer),
        ("cudaLaunchKernel", 0.0, ("serve.call",) + outer),
        ("cudaLaunchKernel", 0.0, ("serve.call",) + outer),
        ("cudaMemcpy", 0.0, outer),
        ("cudaDeviceSynchronize", 0.0, outer),
        ("bench.other", 0.0, ()),
        ("cudaLaunchKernel", 0.0, ()),
        ("serve.call", pytest.approx(18 * US), outer),
        ("vq.quantize", 0.0, ("serve.call",) + outer),
    ]


def _run(events, steps=1):
    t = trace.summarise(events)
    t["steps"] = steps
    return {"trace": t}


READERS = ("host_syncs.train", "host_syncs.serve", "launches.serve", "rir_share.otf")


@pytest.mark.parametrize("name", READERS)
def test_readers_of_the_program_spans_read_nothing_without_them(name):
    read = cell.load_part(cell.load_benchmark(), "metrics", name).read
    assert read(_run(_events(program_spans=False))) is None
    assert read({"trace": None}) is None
    no_card = _run([e for e in _events() if e.device_type == DeviceType.CPU])  # the CPU's trace: no kernel
    assert read(no_card) is None


def test_readers_of_the_serving_span_count_through_the_launching_thread():
    """From the summary's host operations, a call's launches and syncs are
    those with ``serve.call`` around them on their thread: the other
    thread's launch is left out (the span table counts it by time)."""
    bench = cell.load_benchmark()
    run = _run(_events(), steps=2)
    assert cell.load_part(bench, "metrics", "launches.serve").read(run) == 1.0
    assert cell.load_part(bench, "metrics", "host_syncs.serve").read(run) == 0.5
    assert cell.load_part(bench, "metrics", "host_syncs.train").read(run) is None


def test_rir_share_reads_the_synthesis_span():
    window = _event("bench.window", 0, 10, annotation=True)
    rir = _event("synth.rir", 1, 5, annotation=True, parent=window, device_us=2.0)
    run = _run([window, rir, _event("kernel", 2, 6, device=True)])
    assert cell.load_part(cell.load_benchmark(), "metrics", "rir_share.otf").read(run) == pytest.approx(50.0)


def test_span_table_of_a_tiny_serving_run():
    """The span table's run on the CPU: the program's spans and the
    benchmark's, every idle piece given to one of them."""
    import span_table

    out = span_table.table(cell.load_benchmark(), "joint.serve", TINY_SEED, 0.3, torch.device("cpu"), 0.0,
                           overrides=tiny("joint.serve"))
    assert out["correct"] and out["steps"] == 2
    assert {"bench.window", "serve.call", "vq.quantize", "vq.perplexity"} <= set(out["spans"])
    assert out["spans"]["serve.call"]["count"] == 2 and out["spans"]["vq.perplexity"]["count"] == 2
    assert out["self_idle_sum_s"] == pytest.approx(out["idle_s"], rel=1e-9)
    assert out["readings"]["launches.serve"] == 0.0 and out["readings"]["host_syncs.serve"] == 0.0  # no card
    assert out["readings"]["sampler_idle.train"] is None and out["readings"]["rir_share.otf"] is None
