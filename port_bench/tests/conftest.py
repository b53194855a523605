"""Shared set-up of the benchmark's tests: the harness on ``sys.path``, the
overrides that shrink a cell to a CPU run (widths 1/32, a few rows), and the
fixture that skips a test needing the card where there is none."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

TINY_SEED = 123456789012  # a run seed may pass 32 bits


def tiny(cell: str) -> dict:
    """Overrides that run ``cell`` on the CPU in seconds."""
    traffic = {"rows": 8, "latent_rows": 2, "trace_steps": 2, "pool_batches": 2, "compare_within": 1,
               "warmup_steps": 1}
    if "serve" in cell:
        traffic["batch"] = 4
    batch = 2 if "otf" in cell else 4
    return {"width_scale": 1 / 32, "traffic": traffic, "config": {"train_batch": batch}}


@pytest.fixture
def card():
    """The card, for a test marked ``cuda``; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)
