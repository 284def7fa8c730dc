"""Host seconds of WMF's once-per-fit chunk build (the transpose and
``build_chunks``, ``chunks_["build_s"]``), mean over the window's fits."""


def read(run):
    if getattr(run, "model", None) != "WMF":
        return None
    b = [f["build_s"] for f in run.fits if f["build_s"] is not None]
    return sum(b) / len(b) if b else None
