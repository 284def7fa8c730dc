"""Milliseconds a validation call spends moving the tables: the trainer's
two fetches to the host (``tables.fetch`` under ``epoch.evaluate``) and
the evaluator's upload of them (``eval.upload``), mean over the window's
validation calls."""

from benchmark.metrics import _spanlog

EVALUATE = "epoch/epoch.evaluate"


def read(run):
    if getattr(run, "kind", None) != "train":
        return None
    roots = _spanlog.window(f"{run.model.lower()}.fit", len(run.fits))
    calls = _spanlog.total(roots, EVALUATE, "n")
    if not calls:
        return None
    s = sum(st.s for r in roots for path, st in r.paths.items()
            if path == f"{EVALUATE}/tables.fetch"
            or (path.startswith(f"{EVALUATE}/")
                and path.endswith("/eval.upload")))
    return 1e3 * s / calls
