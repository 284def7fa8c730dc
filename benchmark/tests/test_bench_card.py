"""On the card, at each cell's own sizes: the lower-precision control
comes out not correct on three seeds.  Skipped without a card.

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_full_size(card, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--calibrate", "control", "--seeds", "2147483659,77,31337"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert len(lines) == 3 and not any(x["correct"] for x in lines), lines
