"""A run on the CPU at tiny widths: the reference's agreement with the port,
the result line, what a run may load, and the runs that must print nothing."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT, TINY_SEED, tiny

from harness import cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NOT_LOADED = {"jax", "jaxlib", "flax", "acoustic_locating_vq_vae_tpu", "bench", "bench_gpu", "chip_smoke", "scripts"}


def _run(name, **kw):
    return cell.run_cell(cell.load_benchmark(), name, TINY_SEED, 0.3, kw.pop("trace", False), torch.device("cpu"),
                         0.0, overrides=tiny(name), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert list(out["checks"]) and all(c["value"] <= c["limit"] for c in out["checks"].values())
    e2e = {m["name"] for m in cell.cell_metrics(BENCHMARK, name, False)}
    assert set(out["metrics"]) == e2e and "setup_s" in e2e


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    out = _run(name, trace=True)
    assert out["correct"]
    per_layer = {m["name"] for m in cell.cell_metrics(BENCHMARK, name, True)}
    # the CPU runs no device operation: the shares of the card read nothing, the host clock's mfu reads
    assert set(out["metrics"]) <= per_layer and any(k.endswith("mfu") for k in out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"]) and set(out["breakdown"]) == {"device_ops", "idle_gaps"}


SCRIPT = """
import json, sys
sys.path.insert(0, {bench!r}); sys.path.insert(0, {tests!r})
import torch
from conftest import tiny, TINY_SEED
from harness.cell import load_benchmark, run_cell
import run
out = run_cell(load_benchmark(), {cell!r}, TINY_SEED, 0.3, False, torch.device("cpu"), 0.0, overrides=tiny({cell!r}))
run.emit(out)
print(json.dumps(sorted(m for m in sys.modules)))
"""


@pytest.mark.parametrize("name", ["joint.serve", "echoed.train_cached"])
def test_result_line_and_no_jax(name):
    src = SCRIPT.format(bench=str(BENCH), tests=str(BENCH / "tests"), cell=name)
    done = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    lines = done.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    # the checks also end standard error, one line each, after the run's notes
    err = done.stderr.strip().splitlines()
    assert [e.split()[1] for e in err[-len(result["checks"]):]] == list(result["checks"])
    assert any(e.startswith("window ") for e in err) and any(e.startswith("setup ") for e in err)
    # top-level names compared whole: the port's name begins with the JAX package's
    tops = {m.split(".")[0] for m in modules}
    assert not tops & NOT_LOADED
    assert "acoustic_locating_vq_vae_torch" in tops


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed", str(TINY_SEED),
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    src = (f"import sys; sys.path.insert(0, {str(tmp_path / 'port_bench')!r}); import torch;"
           f"from harness.cell import run_cell, load_benchmark;"
           f"run_cell(load_benchmark(), {CELLS[0]!r}, 1, 0.5, False, torch.device('cpu'), 0.0)")
    done = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert done.returncode != 0 and "acoustic_locating_vq_vae_torch" in done.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (NOT_LOADED | {"acoustic_locating_vq_vae_torch", "harness"}), path


def test_benchmark_sources_import_no_jax_and_no_repo_scripts():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & NOT_LOADED, path


@pytest.mark.cuda
def test_cell_on_the_card(card):
    done = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "joint.serve", "--seed",
                           str(TINY_SEED), "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"]
