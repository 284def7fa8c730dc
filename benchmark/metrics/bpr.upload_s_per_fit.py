"""Host seconds of a BPR fit's once-per-fit uploads: the packed tables,
their optimizer state, the static streams and blocks (span
``bpr.upload``), mean over the window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    return _spanlog.mean_per_root("bpr.fit", len(run.fits), "bpr.upload")
