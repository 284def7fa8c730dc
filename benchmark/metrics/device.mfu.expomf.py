"""The window's ExpoMF model work over its wall: the least time the card
could take for it (``roofline.py``) over the window's host-clock length
(the window is never profiled), in percent of the card's peak."""


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or not run.window_s:
        return None
    return 100.0 * run.least_s / run.window_s if run.least_s else None
