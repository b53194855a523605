"""A configuration, a cell, a traffic mix, a loop and metrics are added as
new files and entries alone: a throwaway checkout gets a copy of the
benchmark's files, one new file of each kind and their entries, and the
harness runs the new cell with no existing file edited. A new device-trace
metric carries its own kernel pattern or host operations."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch
from conftest import BENCH, ROOT, TINY_SEED, tiny
from torch.autograd import DeviceType

from harness import cell, trace


def test_new_cell_from_new_files(tmp_path):
    new = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "limits", "metrics", "loops"):
        shutil.copytree(BENCH / sub, new / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in new.rglob("*") if p.is_file()}

    # a new configuration: the joint localizer's sizes and module, loaded by its own name
    config = json.loads((BENCH / "configs" / "joint_localizer.json").read_text())
    config["name"] = "joint_localizer_copy"
    (new / "configs/joint_localizer_copy.json").write_text(json.dumps(config))
    (new / "configs/joint_localizer_copy.py").write_text(
        "from harness.cell import load_benchmark, load_part\n"
        "_joint = load_part(load_benchmark(), 'configs', 'joint_localizer')\n"
        "globals().update({k: v for k, v in vars(_joint).items() if not k.startswith('__')})\n")
    # a new loop: the serving loop with each call served twice, read from its file
    (new / "loops/serve_twice.py").write_text(
        "from harness.cell import load_benchmark, load_part\n"
        "_serve = load_part(load_benchmark(), 'loops', 'serve')\n"
        "class Twice(_serve.Serving):\n"
        "    def step(self):\n"
        "        super().step()\n"
        "        return self.call(self.inputs[0])\n"
        "def setup(ctx):\n"
        "    return Twice(ctx)\n")
    mix = json.loads((BENCH / "traffic" / "serve_closed.json").read_text())
    mix.update(loop="serve_twice", batch=4, pool_batches=2, about="a throwaway mix")
    (new / "traffic/serve_b4.json").write_text(json.dumps(mix))
    (new / "limits/joint.serve_b4.json").write_text((BENCH / "limits" / "joint.serve.json").read_text())
    (new / "metrics/served_calls.py").write_text("def read(run):\n    return float(run['window']['steps'])\n")
    (new / "metrics/twice_samples_per_s.py").write_text(
        "from harness.readers import samples_per_s\n\ndef read(run):\n    return samples_per_s(run)\n")
    bench["configs"].append({"name": "joint_localizer_copy", "source": "https://example.org/copy",
                             "file": "port_bench/configs/joint_localizer_copy.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "joint.serve_b4", "config": "joint_localizer_copy", "traffic": "serve_b4",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "twice_samples_per_s", "unit": "samples/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["joint.serve_b4"]})
    bench["per_layer"].append({"name": "served_calls", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "serving closure", "moves": "twice_samples_per_s",
                               "workloads": ["joint.serve_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = cell.load_benchmark(tmp_path)
    overrides = tiny("joint.serve")
    e2e = cell.run_cell(loaded, "joint.serve_b4", TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                        overrides=overrides)
    assert e2e["correct"] and set(e2e["metrics"]) == {"twice_samples_per_s", "setup_s"}
    assert not cell.run_cell(loaded, "joint.serve_b4", TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                             overrides=overrides, fault="altered_answer")["correct"]
    traced = cell.run_cell(loaded, "joint.serve_b4", TINY_SEED, 0.3, True, torch.device("cpu"), 0.0,
                           overrides=overrides)
    assert traced["metrics"]["served_calls"]["value"] >= 1
    after = {p.relative_to(tmp_path): p.read_bytes() for p in new.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), "an existing file was edited"


def _event(name, start, end, device=False, parent=None, device_us=0.0):
    """An event as ``torch.profiler`` gives it, with what the reduction reads."""
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, is_user_annotation=False,
                           device_time_total=device_us)


def _trace():
    """A window of 1 ms: Adam's step (its foreach op inside it) launching two
    kernels of 100 and 50 us, and a conv launching one of 180 us."""
    adam = _event("Optimizer.step#Adam.step", 100, 300, device_us=150.0)
    events = [_event(trace.WINDOW, 0, 1000), adam,
              _event("aten::_foreach_add_", 110, 200, parent=adam, device_us=150.0),
              _event("aten::convolution", 400, 600, device_us=180.0),
              _event("multi_tensor_apply_kernel<Adam>", 150, 250, device=True),
              _event("multi_tensor_apply_kernel<Adam>", 260, 310, device=True),
              _event("sm80_xmma_fprop_implicit_gemm", 450, 630, device=True)]
    return trace.summarise(events)


def test_new_device_trace_metric_from_its_file_alone(tmp_path):
    """Two new per-layer readers, one by host operation and one by kernel
    name, each with its pattern in its own new file, read a traced window
    with nothing of the harness edited."""
    new = tmp_path / "port_bench" / "metrics"
    shutil.copytree(BENCH / "metrics", new)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (new / "adam_share.train.py").write_text(
        "from harness.readers import share_under\n"
        "OPS = ('Optimizer.step#Adam.step',)\n"
        "def read(run):\n    return share_under(run, OPS)\n")
    (new / "adam_kernel_ms.train.py").write_text(
        "from harness.trace import kernel_time\n"
        "KERNEL = 'multi_tensor_apply_kernel'\n"
        "def read(run):\n"
        "    s, launches = kernel_time(run['trace'], KERNEL)\n"
        "    return 1e3 * s / run['trace']['steps'] if launches else None\n")
    bench = cell.load_benchmark(tmp_path)
    t = {**_trace(), "steps": 2}
    assert t["busy_s"] == pytest.approx(330e-6) and t["window_s"] == pytest.approx(1000e-6)
    run = {"trace": t, "counts": {"conv": 1.0, "vq_calls": []}}
    # the foreach op inside Adam's step is not counted twice
    assert cell.load_part(bench, "metrics", "adam_share.train").read(run) == pytest.approx(100 * 150 / 330)
    assert cell.load_part(bench, "metrics", "adam_kernel_ms.train").read(run) == pytest.approx(0.075)
    # the existing readers take their own patterns from their own files
    conv = cell.load_part(bench, "metrics", "conv_roofline.train")
    assert conv.read(run) == pytest.approx(100 * 1.0 * 2 / 180e-6 / 67e12)
    assert cell.load_part(bench, "metrics", "synth_share.otf").read(run) is None
