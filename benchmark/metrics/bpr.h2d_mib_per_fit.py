"""MiB a BPR fit hands from the host to the card: the ``h2d_bytes``
counter of its ``bpr.fit`` root (once-per-fit uploads, every epoch's
streams and, with validation, the evaluator's table uploads), mean over
the window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    roots = _spanlog.window("bpr.fit", len(run.fits))
    if roots is None:
        return None
    return sum(r.counts.get("h2d_bytes", 0) for r in roots) \
        / len(roots) / 2**20
