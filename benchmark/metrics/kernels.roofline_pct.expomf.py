"""Share of the card's busy time that the profiled ExpoMF fit's model work
needs at least (``roofline.py``: the larger of its float32 operations over
67 TFLOP/s and its compulsory bytes over 3.35 TB/s)."""


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or run.trace is None:
        return None
    busy, least = run.trace["busy_s"], run.least_traced_s
    return 100.0 * least / busy if busy > 0 and least else None
