"""The harness finds cells, configurations, traffic and metrics by name;
nothing under ``benchmark/`` imports JAX or the JAX package, and the
references import nothing of the program; the trace reduction and the
references hold at small sizes."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import devtrace  # noqa: E402


def imported_tops(path: Path):
    """Top-level names of every module a file imports (relative imports
    resolved inside ``benchmark``)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "benchmark"
            else:
                yield node.module.split(".")[0]


def py_files(d: Path):
    return sorted(p for p in d.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "cymf_tpu"}
    for f in py_files(BENCH_DIR):
        found = set(imported_tops(f)) & bad
        assert not found, (f, found)


def test_references_import_nothing_of_the_program():
    for f in py_files(BENCH_DIR / "reference"):
        assert "cymf_tpu_torch" not in set(imported_tops(f)), f


def test_every_name_in_benchmark_json_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        cell = json.loads((BENCH_DIR / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips")} == \
            {k: w[k] for k in ("config", "traffic", "chips")}
        driver = cell.get("driver", w["traffic"])
        assert (BENCH_DIR / "traffic" / f"{driver}.py").exists()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A dummy cell and a dummy per-layer metric, added as files (and
    entries in BENCHMARK.json), run without an edit to any file the
    benchmark has."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "cymf_tpu_torch", tmp_path / "cymf_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/workloads/dummy.json").write_text(json.dumps({
        "config": "bpr-synth20m-d20", "traffic": "fit-dummy", "driver": "fit",
        "chips": 1, "why": "dummy", "params": {"epochs": 1, "warmup_every": 4},
        "limits": {"W_rel": 1.0, "H_rel": 1.0}}))
    (tmp_path / "benchmark/metrics/dummy.fits.py").write_text(
        "def read(run):\n    return float(len(run.fits))\n")
    bench["workloads"].append({"name": "dummy", "config": "bpr-synth20m-d20",
                               "traffic": "fit-dummy", "chips": 1,
                               "why": "dummy"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("dummy")
    bench["per_layer"].append({
        "name": "dummy.fits", "unit": "fits", "better": "higher",
        "source": "program_span", "layer": "trainers",
        "moves": "train_samples_per_s", "workloads": ["dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dummy", "--seed",
         "5", "--seconds", "0", "--trace", "1", "--cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["metrics"]["dummy.fits"]["value"] == 1.0
    assert "trainer.host_s_per_fit" not in out["metrics"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_a_model_without_a_reference_is_a_plain_error(tmp_path):
    """A configuration whose ``reference`` names no module under
    ``reference/`` stops the run with that name, and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "cymf_tpu_torch", tmp_path / "cymf_tpu_torch")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cfg = json.loads((BENCH_DIR / "configs/bpr-synth20m-d20.json")
                     .read_text())
    cfg.update(name="nameless", reference="nameless")
    (tmp_path / "benchmark/configs/nameless.json").write_text(
        json.dumps(cfg))
    cell = json.loads((BENCH_DIR / "workloads/bpr-synth20m-d20.json")
                      .read_text())
    cell["config"] = "nameless"
    (tmp_path / "benchmark/workloads/nameless.json").write_text(
        json.dumps(cell))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nameless",
         "--seed", "5", "--seconds", "0", "--trace", "0", "--cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "names no reference" in p.stderr and "'nameless'" in p.stderr


class _Ev:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, a, b, device=False, annotation=False):
        self._n, self._a, self._b = name, a, b
        self._d, self._u = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._u

    def activity_type(self):
        return "gpu_user_annotation" if self._u and self._d else "kernel"


def _prof(events):
    res = type("R", (), {"events": lambda self: events})()
    inner = type("P", (), {"kineto_results": res})()
    return type("Prof", (), {"profiler": inner})()


def test_trace_summary_on_a_known_timeline():
    ev = [_Ev("bench.recommend", 0, 100, annotation=True),
          _Ev("bench.recommend", 200, 300, annotation=True),
          _Ev("aten::copy_", 40, 90),
          _Ev("gemm", 10, 30, device=True),
          _Ev("topk", 20, 50, device=True),
          _Ev("topk", 210, 260, device=True),
          _Ev("als.correction", 5, 60, device=True, annotation=True)]
    s = devtrace.summarize(_prof(ev))
    assert s["busy_s"] == pytest.approx(90e-9)      # [10,50] + [210,260]
    assert s["span_s"] == pytest.approx(300e-9)
    c = s["calls"]["bench.recommend"]
    assert c["n"] == 2 and c["wall_s"] == pytest.approx(200e-9)
    assert c["busy_s"] == pytest.approx(90e-9)
    assert s["scopes"]["als.correction"] == pytest.approx(40e-9)
    assert s["device_ops"][0] == ["topk", pytest.approx(80e-9)]
    gaps = dict((round(v * 1e9), k) for k, v in s["idle_gaps"])
    assert gaps[160] == "host"                      # [50, 210]: no event
    assert gaps[10] == "bench.recommend"            # [0, 10]
    with pytest.raises(RuntimeError):
        devtrace.summarize(_prof([e for e in ev if not e._d]))


def test_stream_is_the_native_prep_stream():
    """The reference's negative stream against the port's native prep
    (built with the system g++) at ML-20M's catalog and tiny steps."""
    from benchmark.reference import stream
    from cymf_tpu_torch.ops.packed_epoch import (make_reject_filter,
                                                 prep_backend, prep_epoch)
    if prep_backend() != "native":
        pytest.skip("the native prep is not the backend here")
    U, I, S, B = 500, 26744, 3, 4096
    rng = np.random.default_rng(0)
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    keys = np.unique(rng.integers(0, U, 5000).astype(np.int64) * I
                     + rng.integers(0, I, 5000))
    for fit_seed, epoch in ((0, 0), (1234, 7), (2**31 + 5, 49)):
        j2 = prep_epoch(None, u2, i2, keys, U, I, 20, 26880, 256,
                        native_seed=fit_seed * 1_000_003 + epoch,
                        key_filter=make_reject_filter(keys, U, I))[0]
        got = stream.negatives(fit_seed, [epoch], S, B, I, "cpu")[0]
        assert np.array_equal(got.numpy(), j2)


def test_tf32_rounding():
    from benchmark.reference.precision import tf32
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0e-5], dtype=torch.float32)
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10
    assert y[2] == 1.0                    # a tie rounds to even
    assert y[3] == 1.0 + 2**-9            # a tie rounds to even
    assert abs(float(y[4]) + 3.0e-5) < 3.0e-5 * 2**-10


def test_topk_reference_matches_recommend():
    import cymf_tpu_torch as ct
    from scipy import sparse

    from benchmark.reference import topk
    rng = np.random.default_rng(3)
    W = rng.normal(size=(70, 8)).astype(np.float32)
    H = rng.normal(size=(50, 8)).astype(np.float32)
    X = sparse.random(70, 50, density=0.2, format="csr", random_state=4)
    s, i = ct.recommend(W, H, k=5, exclude=X, device="cpu")
    rs, ri = topk.topk(torch.from_numpy(W), torch.from_numpy(H), X, 5)
    assert np.array_equal(i, ri)
    got = topk.judge(torch.from_numpy(W), torch.from_numpy(H), X, 5, s, i)
    assert got == {"rank_gap": 0.0, "score_err": pytest.approx(0, abs=1e-6)}
    i2 = i.copy()
    i2[3, 0] = X[3].indices[0]            # an excluded item
    assert topk.judge(torch.from_numpy(W), torch.from_numpy(H), X, 5, s,
                      i2)["rank_gap"] == float("inf")
