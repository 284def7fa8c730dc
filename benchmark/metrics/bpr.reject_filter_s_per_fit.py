"""Host seconds of a BPR fit's sorted positive keys and rejection filter
for the negative draws (span ``bpr.reject_filter``), mean over the
window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    return _spanlog.mean_per_root("bpr.fit", len(run.fits),
                                  "bpr.reject_filter")
