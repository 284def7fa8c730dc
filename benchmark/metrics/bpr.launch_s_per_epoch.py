"""Host seconds a BPR epoch spends queueing its steps: the self time of
span ``epoch/epoch.run`` (its stream uploads, ``epoch.upload``, left
out), mean over the window's epochs."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    roots = _spanlog.window("bpr.fit", len(run.fits))
    s = _spanlog.total(roots, "epoch/epoch.run", "self_s")
    n = _spanlog.total(roots, "epoch/epoch.run", "n")
    return s / n if s is not None and n else None
