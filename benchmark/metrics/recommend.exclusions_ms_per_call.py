"""Milliseconds a ``recommend`` call spends on its exclusions: the CSR
conversion, the ``indptr`` cast and both uploads (span
``recommend.exclusions``), mean over the window's calls."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "kind", None) != "serve":
        return None
    s = _spanlog.mean_per_root("recommend", run.calls, "recommend.exclusions")
    return 1e3 * s if s is not None else None
