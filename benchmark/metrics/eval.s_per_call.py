"""Seconds of one ``evaluate`` call (host clock around the evaluator the
benchmark passes to ``fit``; it returns host floats), mean over the
window's calls."""


def read(run):
    if getattr(run, "kind", None) != "train":
        return None
    calls = [c[0] for f in run.fits for c in f["evals"]]
    return sum(calls) / len(calls) if calls else None
