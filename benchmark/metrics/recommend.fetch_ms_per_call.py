"""Milliseconds a ``recommend`` call spends bringing its chunks' answers
to the host, each copy waiting for the card to finish the chunk (the
``recommend.fetch`` spans, one a 4,096-user chunk), mean over the
window's calls."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "kind", None) != "serve":
        return None
    s = _spanlog.mean_per_root("recommend", run.calls, "recommend.fetch")
    return 1e3 * s if s is not None else None
