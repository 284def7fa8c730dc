"""Throughput and trace instrumentation (`cymf_tpu/utils/profiling.py`).

* :func:`trace` wraps a block in a ``torch.profiler`` trace, written as a
  Chrome trace (view in ``chrome://tracing``, Perfetto or TensorBoard);
* :func:`annotate` names a region inside it;
* :class:`Throughput` tracks samples/sec with a monotonic clock, used by
  the trainers to report interactions/sec.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with trace("/tmp/torch-trace"): model.fit(...)``: profiles the
    block's host operators and, where a card is visible, its CUDA kernels
    and copies, and on exit (an exception included) writes the Chrome
    trace ``<host>.<pid>.<ns>.pt.trace.json`` into ``logdir``.
    :func:`annotate` regions appear in it by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}.{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a ``torch.profiler`` trace, as a context
    manager.  With no profiler running it costs a few microseconds."""
    return torch.profiler.record_function(name)


class Throughput:
    """Exponentially-smoothed samples/sec counter."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, num_samples: int) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = num_samples / dt
                self.rate = (inst if self.rate is None
                             else self.alpha * inst
                             + (1 - self.alpha) * self.rate)
        self._last = now
        return self.rate

    def format(self) -> str:
        if self.rate is None:
            return ""
        if self.rate >= 1e6:
            return f"{self.rate / 1e6:.2f}M/s"
        if self.rate >= 1e3:
            return f"{self.rate / 1e3:.1f}k/s"
        return f"{self.rate:.0f}/s"
