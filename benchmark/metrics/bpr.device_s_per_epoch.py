"""Seconds of BPR's step loop on the card an epoch (uploads and steps
between CUDA events, ``epoch_times_[e]["device_s"]``), mean over the
window's epochs."""


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    dev = [d for f in run.fits for d in f["device_s"]]
    return sum(dev) / len(dev) if dev else None
