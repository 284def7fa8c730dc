"""The traced run's device trace: ``torch.profiler`` over the stretch
that the traced run profiles after its window, reduced to what the
per-layer metrics and the breakdown read.

All times come from the profiler's own clock: the card's kernel, copy and
set intervals, the program's named scopes as the card ran them
(``gpu_user_annotation``), and the benchmark's own host annotations
(``bench.*``) around each call into the program.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

TRIES = 3
# characters of a device operation's name kept in the breakdown (CUDA
# template names run to thousands)
NAME_CHARS = 160


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _is_annotation(e) -> bool:
    return e.is_user_annotation()


def attach() -> None:
    """Profile one small device operation until the profile holds a
    device event (CUPTI does not always attach); raise after
    :data:`TRIES` profiles without one."""
    for _ in range(TRIES):
        with _profiler() as prof:
            torch.ones(1024, device="cuda").sum().item()
        if any(_is_device(e) and not _is_annotation(e)
               for e in _events(prof)):
            return
    raise RuntimeError(f"torch.profiler saw no device event in {TRIES} "
                       "profiles: the traced run cannot measure the card")


def _union(iv):
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, starts, a, b) -> int:
    """Length of ``[a, b]`` covered by the merged intervals (``starts``:
    their start points as an array)."""
    i = max(int(np.searchsorted(starts, a, "right")) - 1, 0)
    tot = 0
    while i < len(merged) and merged[i][0] < b:
        tot += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return tot


def _intersect(x, y) -> int:
    """Length of the intersection of two merged interval lists."""
    i = j = tot = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        tot += max(0, b - a)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def summarize(prof) -> dict:
    """The profile's numbers, in seconds: ``busy_s`` (union of the card's
    operations within the benchmark's annotations), ``span_s`` (first
    annotation start to last end), ``scopes`` (device time inside each
    named scope, the program's and the benchmark's), ``calls`` (per ``bench.*`` annotation name: the
    count, the summed wall and the device busy time inside them),
    ``device_ops`` and ``idle_gaps`` (the breakdown)."""
    dev, host, gpu_scopes, bench = [], [], defaultdict(list), []
    for e in _events(prof):
        a, b = e.start_ns(), e.end_ns()
        if _is_device(e):
            if _is_annotation(e):
                gpu_scopes[e.name()].append((a, b))
            else:
                dev.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
            if e.name().startswith("bench."):
                bench.append((a, b, e.name()))
    if not dev:
        raise RuntimeError("the traced window's profile holds no device "
                           "event")
    if not bench:
        raise RuntimeError("the traced window holds no bench annotation")
    lo = min(a for a, _, _ in bench)
    hi = max(b for _, b, _ in bench)
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in dev
                   if b > lo and a < hi])
    busy_ns = sum(b - a for a, b in busy)
    by_op = defaultdict(int)
    for a, b, name in dev:
        by_op[name] += b - a
    starts = np.array([m[0] for m in busy], np.int64)
    calls = defaultdict(lambda: [0, 0, 0])
    for a, b, name in bench:
        c = calls[name]
        c[0] += 1
        c[1] += b - a
        c[2] += _overlap(busy, starts, a, b)
    scope_s = {name: _intersect(busy, _union(iv)) / 1e9
               for name, iv in gpu_scopes.items()}
    # idle gaps inside the window, each named by the innermost host event
    # running at its midpoint
    edges = [(lo, lo)] + [tuple(x) for x in busy] + [(hi, hi)]
    gaps = sorted(((edges[k + 1][0] - edges[k][1], edges[k][1],
                    edges[k + 1][0]) for k in range(len(edges) - 1)
                   if edges[k + 1][0] > edges[k][1]), reverse=True)[:10]
    named = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        cover = [(e - s, name) for s, e, name in host if s <= mid <= e]
        named.append([min(cover)[1][:NAME_CHARS] if cover else "host",
                      length / 1e9])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "span_s": (hi - lo) / 1e9,
        "scopes": scope_s,
        "calls": {k: {"n": v[0], "wall_s": v[1] / 1e9, "busy_s": v[2] / 1e9}
                  for k, v in calls.items()},
        "device_ops": [[name[:NAME_CHARS], ns / 1e9] for name, ns in ops],
        "idle_gaps": named,
    }


@contextlib.contextmanager
def window(enabled: bool):
    """Profile the block when ``enabled``; yields a holder whose
    ``prof`` is the finished profile (None when not traced)."""
    holder = type("Traced", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    prof = _profiler()
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
        holder.prof = prof


def annotate(name: str):
    """A ``bench.<name>`` host annotation around one call into the
    program (a no-op cost when nothing profiles)."""
    return torch.profiler.record_function(f"bench.{name}")
