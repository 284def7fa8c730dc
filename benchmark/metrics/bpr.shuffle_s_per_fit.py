"""Host seconds of a BPR fit's input coercion, first table draw and one
shuffle of the interactions (span ``bpr.shuffle``), mean over the
window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    return _spanlog.mean_per_root("bpr.fit", len(run.fits), "bpr.shuffle")
