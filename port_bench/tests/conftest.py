"""Shared pieces of the benchmark's own tests: cells shrunk to run on the
CPU in seconds, and the card fixture for tests that need one."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skip on a machine without a CUDA card, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_cell(name: str, size: int = 48, steps: int = 4,
               dtype: str = "float32") -> dict:
    """The cell `name` of BENCHMARK.json at `size`² on the CPU: `steps`
    steps a request, a stamp every 2, the check's blocks one image."""
    from port_bench import harness
    cell = harness.load_cell(harness.load_spec(ROOT), name)
    cell["config_file"]["stylize"].update(iterations=steps,
                                          compute_dtype=dtype)
    cell["traffic_file"].update(size=size, stamp_every=2, trace_from=2,
                                trace_steps=2)
    cell["check_file"].update(block_rows=size, halo=0)
    return cell


def run_small(cell: dict, seed: int = 2 ** 31 + 7, seconds: float = 2.0,
              device: str = "cpu", trace: bool = False):
    from port_bench import harness
    return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                       device, harness.load_spec(ROOT))
