"""Milliseconds of a ``recommend`` call in which the card ran nothing:
each call's wall less the card's busy time inside it (the exclusion
upload, copies, host gaps), from the device trace's ``bench.recommend``
annotations, mean over the calls."""


def read(run):
    if getattr(run, "kind", None) != "serve" or run.trace is None:
        return None
    c = run.trace["calls"].get("bench.recommend")
    if not c or not c["n"]:
        return None
    return 1e3 * (c["wall_s"] - c["busy_s"]) / c["n"]
