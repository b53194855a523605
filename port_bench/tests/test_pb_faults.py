"""The comparison fails what it must: the control (the reference in float32
with TF32, emulated on the CPU) and each fault a cell can have, planted
under a run at a size a test run holds, with the look for a card skipped."""

import json

import pytest
import torch
from conftest import ROOT, TINY_SEED, tiny

from harness import cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
MIXES = {w["name"]: json.loads((ROOT / "port_bench/traffic" / f"{w['traffic']}.json").read_text())
         for w in BENCHMARK["workloads"]}


def _faults(mix):
    """The faults a cell of the mix can have: a step that leaves its state
    unchanged, half the batch left out, an answer or a sample altered where
    it is produced (one card: no exchange between cards to leave out)."""
    if mix["loop"] == "serve":
        return ("altered_answer",)
    return ("frozen_state", "half_batch") + (("altered_sample",) if mix["source"] == "on_the_fly" else ())


FAULTS = [(name, f) for name, mix in MIXES.items() for f in _faults(mix)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
    out = cell.run_cell(cell.load_benchmark(), name, TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                        overrides=tiny(name), fault=fault)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", [n for n, mix in MIXES.items() if mix["loop"] == "train"])
def test_a_path_taken_only_after_the_first_steps_is_judged(name):
    """Half of each batch left out from the warm-up on: the first three steps
    are sound, and the step after the window alone shows the fault."""
    out = cell.run_cell(cell.load_benchmark(), name, TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                        overrides=tiny(name), fault="late_half_batch")
    assert not out["correct"]
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed and failed <= {"post_loss_gap", "post_median_change_gap", "codes_off"}, failed


@pytest.mark.parametrize("name", list(MIXES))
def test_control_is_not_correct(name):
    out = cell.run_cell(cell.load_benchmark(), name, TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                        overrides=tiny(name), control=True, window=False)
    limits = cell.resolve(cell.load_benchmark(), name)[3]["limits"]
    ctrl = out["_control"]
    assert any(ctrl[k] > v for k, v in limits.items() if k in ctrl), ctrl


@pytest.mark.parametrize("name", [n for n, mix in MIXES.items() if mix.get("source") != "on_the_fly"])
def test_codes_hold_every_sample(name):
    """Each compared sample's codes are read from the program: a sound run
    has them all, so none is counted off for being missing."""
    out = cell.run_cell(cell.load_benchmark(), name, TINY_SEED, 0.3, False, torch.device("cpu"), 0.0,
                        overrides=tiny(name))
    assert out["_numbers"]["codes_off"] == 0
