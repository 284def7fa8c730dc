"""Milliseconds of card time an ExpoMF epoch inside the
``expomf.solve`` scope (each chunk's right-hand side and dense Cholesky solve), from the device trace of the
profiled fit."""


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or run.trace is None:
        return None
    t = run.trace["scopes"].get("expomf.solve")
    epochs = sum(f["epochs"] for f in run.traced)
    return 1e3 * t / epochs if t and epochs else None
