"""Milliseconds of card time a WMF epoch inside the ``als.correction``
scope (the corrections' batched products), from the device trace of the
profiled fit."""


def read(run):
    if getattr(run, "model", None) != "WMF" or run.trace is None:
        return None
    t = run.trace["scopes"].get("als.correction")
    epochs = sum(f["epochs"] for f in run.traced)
    return 1e3 * t / epochs if t and epochs else None
