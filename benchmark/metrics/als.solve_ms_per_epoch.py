"""Milliseconds of card time a WMF epoch inside the solves' scopes
(``als.blocked``, the blocked Cholesky with its diagonal kernel, and
``als.woodbury``), from the device trace of the profiled fit."""


def read(run):
    if getattr(run, "model", None) != "WMF" or run.trace is None:
        return None
    sc = run.trace["scopes"]
    t = sc.get("als.blocked", 0.0) + sc.get("als.woodbury", 0.0)
    epochs = sum(f["epochs"] for f in run.traced)
    return 1e3 * t / epochs if t and epochs else None
