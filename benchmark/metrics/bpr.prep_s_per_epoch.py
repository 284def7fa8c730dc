"""Host seconds of BPR's per-epoch prep (negative draws, rejection,
sorts), mean over the window's epochs: ``epoch_times_[e]["prep_s"]``."""


def read(run):
    if getattr(run, "model", None) != "BPR":
        return None
    prep = [p for f in run.fits for p in f["prep_s"]]
    return sum(prep) / len(prep) if prep else None
