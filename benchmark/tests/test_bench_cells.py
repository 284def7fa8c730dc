"""Each cell end to end on the CPU at its configuration's ``cpu_test``
sizes: one contract line, ``correct`` true; the lower-precision control
and the planted faults each make ``correct`` false.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345


def strict(line):
    """The result line, refused if it holds NaN or Infinity (not JSON)."""
    def reject(token):
        raise ValueError(f"{token} in the result line")
    return json.loads(line, parse_constant=reject)


def run_cell(cell, *extra, seed=SEED, cwd=ROOT):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "0", "--cpu", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    return p


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_contract_line(cell, trace):
    p = run_cell(cell, "--trace", str(trace))
    assert p.returncode == 0, p.stderr[-3000:]
    out = strict(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e, layer = bench_run.metrics_of(BENCH, cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    # the last lines on standard error: each number beside its limit
    tail = p.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


@pytest.mark.parametrize("mode", ["control", "unchanged", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, mode):
    p = run_cell(cell, "--calibrate", mode, "--seeds", f"{SEED},7")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert len(lines) == 2
    assert not any(x["correct"] for x in lines), lines


def _main(cell, capsys):
    rc = bench_run.main(["--workload", cell, "--seed", str(SEED),
                         "--seconds", "0", "--trace", "0", "--cpu"])
    assert rc == 0
    return strict(capsys.readouterr().out.strip().splitlines()[-1])


def test_fault_state_unchanged(monkeypatch, capsys):
    from cymf_tpu_torch.models import base
    monkeypatch.setattr(base.MFTrainerBase, "_run_epochs",
                        lambda self, *a, **k: None)
    for cell in ("bpr-synth20m-d20", "wmf-synth20m-d256"):
        assert _main(cell, capsys)["correct"] is False


def test_fault_half_the_batch(monkeypatch, capsys):
    from cymf_tpu_torch.models import bpr, wmf
    epoch = bpr.packed_bpr_epoch

    def half_epoch(*a, **k):
        mask = a[10].clone()
        mask[:, : mask.shape[1] // 2] = 0
        return epoch(*a[:10], mask, *a[11:], **k)

    solve, wood = wmf.wmf_chunk_solve, wmf.wmf_chunk_solve_woodbury

    def half_valid(valid):
        v = valid.clone()
        v[:, v.shape[1] // 2:] = False
        return v

    monkeypatch.setattr(bpr, "packed_bpr_epoch", half_epoch)
    monkeypatch.setattr(wmf, "wmf_chunk_solve",
                        lambda Y, A0, i, v, w, **k: solve(
                            Y, A0, i, half_valid(v), w, **k))
    monkeypatch.setattr(wmf, "wmf_chunk_solve_woodbury",
                        lambda Y, A0i, i, v, w, **k: wood(
                            Y, A0i, i, half_valid(v), w, **k))
    for cell in ("bpr-synth20m-d20", "wmf-synth20m-d256", "bpr-synth20m-d20-valid"):
        assert _main(cell, capsys)["correct"] is False


def test_fault_answer_altered(monkeypatch, capsys):
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.evaluation import evaluator
    from cymf_tpu_torch.models import base
    rec = ct.recommend

    def altered(*a, **k):
        scores, items = rec(*a, **k)
        items = items.copy()
        items[0, 0] = (items[0, 0] + 1) % a[1].shape[0]
        return scores, items

    monkeypatch.setattr(ct, "recommend", altered)
    assert _main("bpr-synth20m-d20-recommend", capsys)["correct"] is False

    def excluded(*a, **k):
        scores, items = rec(*a, **k)
        items = items.copy()
        items[0, 0] = k["exclude"][0].indices[0]
        return scores, items

    monkeypatch.setattr(ct, "recommend", excluded)
    out = _main("bpr-synth20m-d20-recommend", capsys)
    assert out["correct"] is False
    assert out["checks"]["rank_gap"]["value"] == "inf"

    drop = base.MFTrainerBase._drop_device_state

    def nudged(self):
        drop(self)
        if self._W_host is not None:
            self._W_host = self._W_host.copy()
            self._W_host[0] += 0.01
    monkeypatch.setattr(base.MFTrainerBase, "_drop_device_state", nudged)
    for cell in ("bpr-synth20m-d20", "wmf-synth20m-d256"):
        assert _main(cell, capsys)["correct"] is False
    monkeypatch.setattr(base.MFTrainerBase, "_drop_device_state", drop)

    ev = evaluator.Evaluator.evaluate

    def off(self, W, H, *a, **k):
        return {key: v * 1.01 for key, v in ev(self, W, H, *a, **k).items()}
    monkeypatch.setattr(evaluator.Evaluator, "evaluate", off)
    assert _main("bpr-synth20m-d20-valid", capsys)["correct"] is False


def test_needs_a_card_without_cpu_flag():
    """Without CUDA (this machine) a run exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_runs_only_beside_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = run_cell(CELLS[0], "--trace", "0", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_same_seed_same_inputs():
    from benchmark import data
    cfg = json.loads((ROOT / "benchmark/configs/bpr-synth20m-d20.json")
                     .read_text())["cpu_test"]
    a, b = data.interactions(cfg, SEED), data.interactions(cfg, SEED)
    c = data.interactions(cfg, SEED + 1)
    assert (a != b).nnz == 0 and (a != c).nnz > 0
    assert np.array_equal(*(data.uniform_tables(5, 4, 3, 11, "cpu")[0]
                            .numpy() for _ in range(2)))
