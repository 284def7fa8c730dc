"""Share of the traced run's profiled ExpoMF fit in which no operation ran
on the card: one less the union of the profiler's kernel, copy and set
intervals over the stretch's span."""


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or run.trace is None:
        return None
    span = run.trace["span_s"]
    return 100.0 * (1.0 - run.trace["busy_s"] / span) if span > 0 else None
