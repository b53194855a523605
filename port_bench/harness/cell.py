"""One run of one cell: set-up, the measured window, the traced window on
request, the check, the result line.

Everything that belongs to one cell, configuration, traffic mix, loop or
metric is a file of its own, found by name; nothing here names one:

* the cell's entry in ``BENCHMARK.json`` names its configuration, whose file
  of sizes is ``configs/<config>.json`` and whose module
  ``configs/<config>.py`` builds the program's task and holds the state-dict
  layout, the FLOP count and the reference's loss or answers; and its
  traffic mix, a data file ``traffic/<traffic>.json``; the cell's
  correctness limits and the readings they were set from are
  ``limits/<cell>.json``;
* the mix's ``loop`` names ``loops/<loop>.py``: the set-up of the
  program's call, the timed step, the window's loop and the check of what
  the step produced (``harness/window.py:Loop``);
* each metric is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import card, check, inputs
from .trace import traced_window
from .weights import make_params

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "flax", "acoustic_locating_vq_vae_tpu")
HOST_THREADS = 1


def sub_seed(seed: int, tag: int) -> int:
    """A seed of its own for each stream of a run, from ``--seed``."""
    return (int(seed) * 1_000_003 + tag) % (2 ** 63)


def load_benchmark(root: Optional[Path] = None) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root`` (default this one); the
    files it names are read from that checkout (its ``_root``)."""
    root = Path(root or ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["_root"] = str(root)
    return bench


def _bench_dir(bench: dict) -> Path:
    return Path(bench.get("_root", ROOT)) / bench["paths"][0]


def resolve(bench: dict, cell: str, overrides: Optional[dict] = None):
    """(cell entry, configuration, traffic, limits) of ``cell``; ``overrides``
    (tests only) replace keys of the configuration, the traffic and the
    limits, and ``width_scale`` scales the widths."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[cell]
    root = Path(bench.get("_root", ROOT))
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((_bench_dir(bench) / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((_bench_dir(bench) / "limits" / f"{cell}.json").read_text())
    o = overrides or {}
    from reference.model import scaled_config

    cfg = scaled_config({**cfg, **o.get("config", {})}, o.get("width_scale", 1.0))
    traffic = {**traffic, **o.get("traffic", {})}
    limits = {**limits, **o.get("limits", {})}
    return entry, cfg, traffic, limits


def setup_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (from the
    kernel's start time of the process)."""
    try:
        import os

        ticks = os.sysconf("SC_CLK_TCK")
        start = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


_PARTS: Dict[Path, object] = {}


def load_part(bench: dict, kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (a configuration
    under ``configs``, a loop under ``loops``, a reader under
    ``metrics``), loaded once."""
    path = (_bench_dir(bench) / kind / f"{name}.py").resolve()
    if path not in _PARTS:
        if not path.is_file():
            raise SystemExit(f"no {kind} module {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PARTS[path] = mod
    return _PARTS[path]


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metric entries a run of ``cell`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def port_on_path() -> None:
    """The program's package (``src/``) importable."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def _kernels(device: torch.device) -> bool:
    """Build (a checkout's first run) and load the program's hand kernels
    now, so that their build is a set-up phase of its own; True where they
    were built."""
    if device.type != "cuda":
        return False
    from acoustic_locating_vq_vae_torch.ops import kernels

    built = not all(kernels.library_path(source).exists() for source in kernels.SOURCES)
    kernels.build_all()
    for source in kernels.SOURCES:
        kernels.library(source)
    return built


def check_shapes(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """The program's model has exactly the reference's keys and shapes."""
    sd = model.state_dict()
    if set(sd) != set(params) or any(tuple(sd[k].shape) != tuple(params[k].shape) for k in sd):
        missing, extra = sorted(set(params) - set(sd))[:4], sorted(set(sd) - set(params))[:4]
        raise RuntimeError(f"the program's model is not the configuration's: missing {missing}, extra {extra}")


class Context:
    """What a loop's set-up is handed: the cell's files, the run's
    arguments, the inputs and weights made from the seed, and the program's
    task object."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def mark(self, name: str) -> None:
        """End of a set-up phase, in seconds since the process started."""
        self.phases.append((name, time.perf_counter() - self.t_start))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, overrides: Optional[dict] = None, fault: Optional[str] = None,
             window: bool = True, control: bool = False) -> dict:
    """One run; returns the result line's object with ``checks`` last, and
    the numbers behind them under ``_numbers``. ``fault`` plants one of the
    faults the check must catch (tests and ``control.py``; each loop names
    its own). ``window=False`` (the control script) makes no timed window.
    ``control`` adds the control's numbers."""
    entry, cfg, traffic, limits = resolve(bench, cell, overrides)
    port_on_path()
    from acoustic_locating_vq_vae_torch.data.config import DatasetConfig

    torch.set_num_threads(HOST_THREADS)
    ctx = Context(bench=bench, cell=cell, cfg=cfg, traffic=traffic, limits=limits, geometry=cfg["geometry"],
                  seed=seed, device=device, fault=fault, trace=trace, t_start=t_start, phases=[],
                  width_scale=(overrides or {}).get("width_scale", 1.0))
    ctx.mark("imports")
    ctx.kernels_built = _kernels(device)
    ctx.mark("kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx.batch = traffic.get("batch", cfg.get("train_batch"))
    ctx.frames = int(cfg["geometry"]["num_frames"])
    ctx.config = load_part(bench, "configs", entry["config"])
    loop_module = load_part(bench, "loops", traffic["loop"])
    for name in getattr(loop_module, "PROGRAM", ()):  # the program's modules the loop calls, imported in this phase
        importlib.import_module(name)
    ctx.mark("program imports")

    # ------------------------------------------------------------- set-up
    ctx.gen = torch.Generator(device).manual_seed(sub_seed(seed, 1))
    latent = inputs.spectrograms(ctx.gen, traffic["latent_rows"], cfg["geometry"])
    ctx.params = make_params(ctx.config, cfg, ctx.gen, latent)
    del latent
    ctx.mark("weights")
    ctx.geo = DatasetConfig(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["geometry"].items()})
    ctx.port_task = ctx.config.build(cfg, ctx.geo, ctx.width_scale)
    loop = loop_module.setup(ctx)
    gc.collect()
    gc.freeze()  # set-up's objects live for the run: the collector's scans in the window leave them out
    setup_s = time.perf_counter() - t_start
    before = card.sample(device)  # the benchmark's own reading, not the program's set-up

    # ----------------------------------------------------- measured window
    result_window: Dict = {"steps": 0, "seconds": 0.0, "latencies": []}
    if window:
        result_window = loop.window(seconds)
    after = card.sample(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loop.after_window()
    traced = traced_window(loop, traffic["trace_steps"], ctx.sync) if trace and window else None

    # ----------------------------------------------- free, then the check
    loop.release()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, control_numbers = loop.check(control)

    # -------------------------------------------------------------- result
    checks = check.judge(numbers, limits["limits"])
    info = card.device_info(device)
    dev = {"platform": info["platform"], "kind": info["kind"], "count": 1, "memory_peak_bytes": int(memory_peak)}
    run = {"cfg": cfg, "traffic": traffic, "batch": ctx.batch, "frames": ctx.frames, "window": result_window,
           "counts": loop.counts, "trace": traced, "setup_s": setup_s}
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_part(bench, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": check.passes(checks), "attempted": int(result_window["steps"]), "failed": 0,
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    out["checks"] = checks
    out["_numbers"] = numbers
    out["_notes"] = {"power_limit": info["power_limit"], "card_before": before, "card_after": after,
                     "steps": result_window["steps"], "window_s": result_window["seconds"],
                     "setup_phases_s": dict(ctx.phases), "kernels_built": ctx.kernels_built,
                     "trace_read_s": traced["read_s"] if traced else None}
    if control_numbers is not None:
        out["_control"] = control_numbers
    return out
