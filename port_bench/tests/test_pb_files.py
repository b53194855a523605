"""``BENCHMARK.json`` against the benchmark's contract, and every piece it
names found as a file of its own."""

import json
import re

from conftest import BENCH, ROOT

from harness import cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per",
               "embedding_dim", "num_embeddings")


def test_top_level_keys_and_sizes():
    assert list(BENCHMARK) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCHMARK["paths"] == ["port_bench"] and BENCHMARK["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(BENCHMARK["run_seconds"], int) and 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCHMARK["workloads"]) <= 24 and 1 <= len(BENCHMARK["configs"]) <= 24
    assert 1 <= len(BENCHMARK["end_to_end"]) <= 16 and 1 <= len(BENCHMARK["per_layer"]) <= 128


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"})):
        for e in BENCHMARK[group]:
            assert set(e) <= keys and NAME.match(e["name"]), e
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_cells_and_configurations():
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    used = set()
    for w in BENCHMARK["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
        used.add(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{mix['loop']}.py").is_file()
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]}) == len(BENCHMARK["workloads"])
    for c in configs.values():
        assert c["file"].startswith("port_bench/configs/") and (ROOT / c["file"]).is_file()
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)
        assert c["source"].startswith("https://")


def test_metrics_bounds_and_readers():
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell_name in cells:
        reported = [m for m in e2e.values() if cell_name in m.get("workloads", cells)]
        assert len(reported) >= 2 and cell.cell_metrics(BENCHMARK, cell_name, True)
    for m in BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # every cell the metric lists reports the end-to-end metric it moves
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
        if m["unit"] == "%" and (m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
