"""Host seconds of a BPR fit's minibatch padding and per-step user sort
(span ``bpr.batches``), mean over the window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    return _spanlog.mean_per_root("bpr.fit", len(run.fits), "bpr.batches")
