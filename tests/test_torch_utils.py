"""The port's ``utils.profiling``: ``trace`` writes a Chrome trace that
holds the ``annotate`` regions of its block."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from cymf_tpu_torch.utils import Throughput, annotate, trace


def test_trace_writes_chrome_trace_with_annotations(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("cymf_region"):
            torch.ones(64).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "cymf_region" for e in events)


def test_trace_writes_on_exception(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError):
        with trace(logdir):
            with annotate("before_failure"):
                torch.ones(8).sum()
            raise RuntimeError("fit failed")
    assert len(glob.glob(os.path.join(logdir, "*.pt.trace.json"))) == 1


def test_throughput_smooths_rates():
    thr = Throughput(alpha=0.5)
    assert thr.tick(0) is None and thr.format() == ""
    thr._last -= 1.0                    # one second since the last tick
    rate = thr.tick(2_000_000)
    assert rate == pytest.approx(2e6, rel=0.01)
    assert thr.format().endswith("M/s")
    assert np.isfinite(thr.rate)
