"""Share of the card's time inside the profiled ExpoMF fit's
``expomf.gramian`` scope that the Gramians' least work needs: R Co K (K + 1)
float32 operations a half sweep (each target row's symmetric
exposure-weighted Gramian over the other side's Co rows, every distinct
product once) at 67 TFLOP/s (``roofline.py``).  R counts the target
rows with a click: the rows of the fit's tables that are not zero (the
program zeroes the others)."""

import numpy as np

from benchmark import roofline


def read(run):
    if getattr(run, "model", None) != "ExpoMF" or run.trace is None:
        return None
    t = run.trace["scopes"].get("expomf.gramian")
    if not t:
        return None
    flops = 0.0
    for f in run.traced:
        W, H = np.asarray(f["W"]), np.asarray(f["H"])
        K = W.shape[1]
        live_w = int(np.any(W != 0, axis=1).sum())
        live_h = int(np.any(H != 0, axis=1).sum())
        flops += f["epochs"] * float(live_w * len(H) + live_h * len(W)) \
            * K * (K + 1)
    return 100.0 * flops / roofline.PEAK_F32_S / t
