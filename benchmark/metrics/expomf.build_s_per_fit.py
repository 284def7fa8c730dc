"""Host seconds of ExpoMF's once-per-fit build (span ``expomf.build``:
the transpose, both sides' ``build_chunks`` and their placement on the
card), mean over the window's fits."""

from benchmark.metrics import _spanlog


def read(run):
    if getattr(run, "model", None) != "ExpoMF":
        return None
    return _spanlog.mean_per_root("expomf.fit", len(run.fits),
                                  "expomf.build")
