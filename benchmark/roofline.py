"""Peaks of the card and the model work of each kind of call, frozen here.

The least time the card could take for some work is the larger of its
float32 operations over the float32 rate and its compulsory bytes (each
input read once, each output written once) over the memory rate: the
arithmetic of the port's ``chip_smoke.py::bound()``.  The counts are
functions of the configuration's shapes and the seeded data alone, so a
later change to a kernel cannot move them.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores (TF32 is off on the measured path)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_F32_S, nbytes / PEAK_BYTES_S)


def bpr_step(w_rows: int, h_rows: int, batch: int, K: int) -> tuple:
    """``(flops, bytes)`` of one synchronous BPR step: each distinct row of
    W and H that the step touches read and written once with its two Adam
    moments, the step's user, positive and negative ids read once, ~15 K
    operations a sample (dot, difference, sigmoid, three gradients, the
    L2 terms, three accumulations) and ~12 a touched element (decay, Adam)."""
    rows = w_rows + h_rows
    nbytes = rows * K * F32 * 3 * 2 + batch * 3 * 4
    flops = batch * 15 * K + rows * K * 12
    return flops, nbytes


def wmf_half_sweep(degrees: np.ndarray, n_source: int, K: int) -> tuple:
    """``(flops, bytes)`` of one ALS half sweep in its normal-equation
    form: the source table's Gramian (2 n K^2), per target row with p
    positives the correction 2 p K^2, the right-hand side 2 p K and a
    Cholesky solve K^3 / 3 + 2 K^2 (rows with no positive are zeroed);
    bytes: the source table read, the target written, the positive ids
    read."""
    deg = np.asarray(degrees, np.float64)
    live = float((deg > 0).sum())
    p = float(deg.sum())
    flops = (2.0 * n_source * K * K + 2.0 * p * K * K + 2.0 * p * K
             + live * (K ** 3 / 3.0 + 2.0 * K * K))
    nbytes = (n_source + len(deg)) * K * F32 + p * 4
    return flops, nbytes


def recommend_call(U: int, I: int, K: int, k: int, n_excl: int) -> tuple:
    """``(flops, bytes)`` of one full-catalog top-k call: 2 U I K for the
    scores; both tables and the exclusion CSR read once, the ids and
    scores written once."""
    flops = 2.0 * U * I * K
    nbytes = (U + I) * K * F32 + n_excl * 4 + (U + 1) * 8 + U * k * (4 + 4)
    return flops, nbytes
