"""The program's span log as the per-layer metrics of ``program_span``
source read it (``cymf_tpu_torch.utils.profiling.spans()``: one record a
root span, with each path under it and its counters)."""


def window(name: str, n: int):
    """The last ``n`` roots named ``name`` that no profiler saw and no
    exception left: the window's fits or calls (the warm-up runs before
    them; the traced run profiles its stretch after them).  None where the
    log holds fewer, or where the program keeps no span log: the benchmark
    also runs against versions of the program older than the log, and a
    reader that raised there would fail the whole run."""
    from cymf_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None or n < 1:
        return None
    roots = [r for r in spans()
             if r.name == name and not r.profiled and not r.error]
    return roots[-n:] if len(roots) >= n else None


def total(roots, path: str, field: str = "s"):
    """``field`` of ``path`` (``s``, ``self_s`` or ``n``) summed over
    ``roots``; None where a root lacks the path."""
    if not roots or any(path not in r.paths for r in roots):
        return None
    return sum(getattr(r.paths[path], field) for r in roots)


def mean_per_root(name: str, n: int, path: str):
    """Seconds of ``path`` a root, mean over the window's ``n`` roots
    named ``name``."""
    roots = window(name, n)
    s = total(roots, path)
    return s / len(roots) if s is not None else None
