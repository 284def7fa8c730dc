"""Host seconds of the packed engine's once-per-fit static prep (windows,
item sort permutations, blocks: span ``bpr.prep_static``), mean over the
window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    return _spanlog.mean_per_root("bpr.fit", len(run.fits),
                                  "bpr.prep_static")
