"""Seconds the launching thread of a BPR fit waits an epoch for the
epoch's host prep (the worker's future, or epoch 0's prep run inline:
span ``epoch/epoch.prep_wait``), mean over the window's epochs."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    roots = _spanlog.window("bpr.fit", len(run.fits))
    s = _spanlog.total(roots, "epoch/epoch.prep_wait")
    n = _spanlog.total(roots, "epoch/epoch.prep_wait", "n")
    return s / n if s is not None and n else None
