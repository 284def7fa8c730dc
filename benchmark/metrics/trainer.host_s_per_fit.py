"""Seconds of a fit spent off the card, mean over the window's fits: the
fit's wall (host clock around ``fit``) less its device seconds (BPR: the
CUDA events around each epoch's steps, ``epoch_times_[e]["device_s"]``;
WMF: each synchronised epoch, ``epoch_times_``) and less its
``evaluate`` calls: once-per-fit prep, uploads and publishing."""


def read(run):
    if getattr(run, "kind", None) != "train" or not run.fits:
        return None
    off = [f["wall"] - sum(f["device_s"]) - sum(c[0] for c in f["evals"])
           for f in run.fits]
    return sum(off) / len(off)
