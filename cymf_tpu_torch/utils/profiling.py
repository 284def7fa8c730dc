"""Spans, counters and trace instrumentation (`cymf_tpu/utils/profiling.py`).

* :func:`span` times a named region on the host clock and nests through a
  per-thread stack; :func:`count` adds to the innermost open span's
  counters.  When a span with no open parent (a root) closes, one
  :class:`Root` record of it and everything under it goes into an
  in-memory log of the last :data:`LOG_ROOTS` roots, which :func:`spans`
  returns.  The log is always kept; a span costs two clock reads and a
  few dictionary updates.  While a ``torch.profiler`` runs, a span also
  opens ``torch.profiler.record_function(name)``, so it appears in the
  profile as a host range beside the card's kernels and copies;
  :func:`annotate` is the same function under the JAX package's name;
* :func:`trace` wraps a block in a ``torch.profiler`` trace, written as a
  Chrome trace (view in ``chrome://tracing``, Perfetto or TensorBoard);
* :class:`Throughput` is an exponentially smoothed samples/sec counter.

The program's spans: every estimator's ``fit`` opens ``<model>.fit``
(``bpr.fit``, ``wmf.fit``, ...), ``Evaluator.evaluate`` opens
``eval.evaluate`` and ``recommend`` opens ``recommend``; the stages inside
them are named in their modules.  Two counters are kept: ``h2d_bytes``
(bytes handed from the host to the device, :func:`upload` and
:func:`upload_array`) and ``samples`` (interactions trained, on a fit).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import socket
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

# roots the log keeps (the oldest are dropped)
LOG_ROOTS = 1024

_log: collections.deque = collections.deque(maxlen=LOG_ROOTS)
_local = threading.local()


@dataclasses.dataclass
class PathStat:
    """The spans of one path under a root: how many closed (``n``),
    their total and self seconds (self: total less the children that ran
    on the same thread) and their counters, children's included."""
    n: int = 0
    s: float = 0.0
    self_s: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Root:
    """One root span and everything under it: ``paths`` maps each path
    below the root (names joined by ``/``, the root's own left out) to
    its :class:`PathStat`; ``counts`` totals every counter under the
    root.  ``start_ns`` and ``end_ns`` are ``time.perf_counter_ns()``
    readings; ``profiled``: a profiler ran when the root opened;
    ``error``: an exception left it."""
    name: str
    start_ns: int
    end_ns: int = 0
    profiled: bool = False
    error: bool = False
    self_s: float = 0.0
    paths: Dict[str, PathStat] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _add(into: Dict[str, int], counts: Dict[str, int]) -> None:
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


class _Span:
    """An open span (see :func:`span`)."""

    __slots__ = ("name", "path", "parent", "root", "record", "counts",
                 "start_ns", "end_ns", "child_ns", "foreign", "_rf", "_own",
                 "_st")

    def __init__(self, name: str, parent: Optional["_Span"], counts: dict):
        self.name = name
        self.parent = parent
        self.counts = counts
        self.child_ns = 0
        self.end_ns = 0
        self._rf = None

    def __enter__(self) -> "_Span":
        try:
            st = _local.stack
        except AttributeError:
            st = _local.stack = []
        self._st = st
        # the given parent, else the innermost open span of this thread;
        # only the latter has this span's time taken from its self time
        self._own = own = self.parent is None
        if own and st:
            self.parent = st[-1]
        parent = self.parent
        profiled = torch.autograd._profiler_enabled()
        if parent is None:
            self.path = ""
            self.root = self
            self.record = Root(self.name, 0, profiled=profiled)
            # what spans of other threads hand to this root (a deque's
            # append is atomic); merged when the root closes
            self.foreign = collections.deque()
        else:
            self.path = (f"{parent.path}/{self.name}" if parent.path
                         else self.name)
            self.root = parent.root
        if profiled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        st.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = end = time.perf_counter_ns()
        st = self._st
        if st and st[-1] is self:
            st.pop()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        total = end - self.start_ns
        parent = self.parent
        if parent is None:
            r = self.record
            r.start_ns, r.end_ns = self.start_ns, end
            r.error = exc_type is not None
            r.self_s = (total - self.child_ns) / 1e9
            while self.foreign:
                path, t, own_t, counts = self.foreign.popleft()
                _merge(r.paths, path, t, own_t, counts)
                _add(self.counts, counts)
            _add(r.counts, self.counts)
            _log.append(r)
            return False
        if not self._own:
            # a span attached to another thread's span: its root merges it
            self.root.foreign.append((self.path, total, total - self.child_ns,
                                      self.counts))
            return False
        parent.child_ns += total
        _merge(self.root.record.paths, self.path, total,
               total - self.child_ns, self.counts)
        if self.counts:
            _add(parent.counts, self.counts)
        return False

    @property
    def seconds(self) -> float:
        """Seconds from entry to exit (to now, while open)."""
        return ((self.end_ns or time.perf_counter_ns()) - self.start_ns) / 1e9


def _merge(paths: Dict[str, PathStat], path: str, total_ns: int,
           self_ns: int, counts: Dict[str, int]) -> None:
    stat = paths.get(path)
    if stat is None:
        stat = paths[path] = PathStat()
    stat.n += 1
    stat.s += total_ns / 1e9
    stat.self_s += self_ns / 1e9
    if counts:
        _add(stat.counts, counts)


def span(name: str, parent: Optional[_Span] = None, **counts: int) -> _Span:
    """``with span("bpr.shuffle"): ...`` times the block on the host clock,
    as a child of the innermost span open on this thread (a root where
    none is), and yields the open span: ``.seconds`` after the block is its
    length, ``.counts`` what was counted under it.  ``counts`` start its
    counters.  ``parent`` (an open span, from :func:`current`) attaches
    the span to a span of another thread instead: a worker's spans then
    join the root that handed work to it when that root closes, and are
    not subtracted from any span of the launching thread."""
    return _Span(name, parent, counts)


annotate = span


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def current() -> Optional[_Span]:
    """The innermost span open on this thread, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost span open on
    this thread (nothing where none is)."""
    st = getattr(_local, "stack", None)
    if st:
        c = st[-1].counts
        c[name] = c.get(name, 0) + n


def upload(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None,
           copy: bool = False) -> torch.Tensor:
    """``t.to(device, dtype, copy=copy)``, with the bytes of a host tensor
    counted as ``h2d_bytes`` (on the CPU too, where the copy is none: the
    count is what a card would receive; a blocking copy sends ``t``'s own
    bytes and converts on the card)."""
    if t.device.type == "cpu":
        count("h2d_bytes", t.nbytes)
    return t.to(device, dtype, copy=copy)


def upload_array(a, device, dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``, through
    :func:`upload`.  With ``dtype``, a copy converted on the host, so that
    only its bytes cross and in-place updates of the result never reach
    ``a``; without, ``a``'s own bytes (on the CPU the result shares ``a``'s
    memory)."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if dtype is None \
        else torch.tensor(a, dtype=dtype)
    return upload(t, device)


def spans() -> List[Root]:
    """The log: the last :data:`LOG_ROOTS` roots, oldest first."""
    return list(_log)


def format_rate(rate: float) -> str:
    """``rate`` per second, shortened: ``1.23M/s``, ``4.5k/s``, ``67/s``."""
    if rate >= 1e6:
        return f"{rate / 1e6:.2f}M/s"
    if rate >= 1e3:
        return f"{rate / 1e3:.1f}k/s"
    return f"{rate:.0f}/s"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with trace("/tmp/torch-trace"): model.fit(...)``: profiles the
    block's host operators and, where a card is visible, its CUDA kernels
    and copies, and on exit (an exception included) writes the Chrome
    trace ``<host>.<pid>.<ns>.pt.trace.json`` into ``logdir``.
    The program's spans appear in it by name."""
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
        return "" if self.rate is None else format_rate(self.rate)
