"""Seconds of an ExpoMF fit spent off the card, mean over the window's
fits: the fit's wall (host clock around ``fit``) less its synchronised
epochs (``epoch_times_``): the transpose, the chunk build, uploads and
publishing."""


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or not run.fits:
        return None
    off = [f["wall"] - sum(f["device_s"]) for f in run.fits]
    return sum(off) / len(off)
