"""Host seconds of a WMF fit's uploads: the chunks placed on the card and
both tables (span ``wmf.upload``), mean over the window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "WMF":
        return None
    return _spanlog.mean_per_root("wmf.fit", len(run.fits), "wmf.upload")
