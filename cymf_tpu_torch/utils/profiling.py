"""Throughput and trace instrumentation (`cymf_tpu/utils/profiling.py`).

:class:`Throughput` and :func:`annotate` are ported; ``trace`` comes with
the ``torch.profiler`` work.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


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
