"""The port's ExpoMF against the plain reference that decides the
benchmark's ``correct`` (``benchmark/reference/expomf.py``: float32
PyTorch, the Gramians formed row by row, nothing of the port).

At 300 users x 211 items, K = 100 and 3 EM epochs, from seeded uniform
tables, ``W``, ``H`` and ``mu`` agree to :data:`TOL` in relative Frobenius
norm.  The float32 round-off of the Gramians and right-hand sides reaches
the solutions through the solves' conditioning, in the program and the
reference alike (each lies ~4e-5 from a float64 replay at the benchmark's
CPU sizes); here the two lie ~2.5e-5 apart, ``mu`` ~1e-7.  :data:`TOL`
leaves eight times that.  Each planted fault must break it: the exposure
1 everywhere (~0.4), the item sweep solved over the epoch-start W (~0.2)
and a TF32-rounded Gramian (operands rounded to 10 mantissa bits, ~1e-2).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cymf_tpu_torch as ct  # noqa: E402
from benchmark.reference import expomf as ref  # noqa: E402
from benchmark.reference.precision import tf32  # noqa: E402
from cymf_tpu_torch.models import expomf  # noqa: E402

TOL = 2e-4
U, I, K, EPOCHS = 300, 211, 100, 3


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    X = sparse.random(U, I, density=0.06, format="csr", random_state=seed,
                      data_rvs=np.ones)
    X.sort_indices()
    W0 = (rng.uniform(-0.1, 0.1, (U, K)) / K).astype(np.float32)
    H0 = (rng.uniform(-0.1, 0.1, (I, K)) / K).astype(np.float32)
    return X, W0, H0


def _exposure_one(monkeypatch):
    real = expomf.exposure
    monkeypatch.setattr(expomf, "exposure",
                        lambda *a: torch.ones_like(real(*a)))


def _item_sweep_over_w0(monkeypatch):
    # the item sweep's normal equations over its exposure's table (W0),
    # not the updated W; the user sweep passes H0 for both already
    real = expomf.expomf_chunk
    monkeypatch.setattr(expomf, "expomf_chunk",
                        lambda E_src, E_other, Y, *a, **k: real(
                            E_src, E_other, E_other, *a, **k))


def _tf32_gramian(monkeypatch):
    def gramian(E, Y):
        Yf = Y.float()
        YY = (Yf[:, :, None] * Yf[:, None, :]).reshape(len(Yf), -1)
        return (tf32(E.float()) @ tf32(YY)).view(-1, Y.shape[1],
                                                Y.shape[1])
    monkeypatch.setattr(expomf, "weighted_gramian", gramian)


FAULTS = {"none": None, "exposure_one": _exposure_one,
          "item_sweep_over_w0": _item_sweep_over_w0,
          "tf32_gramian": _tf32_gramian}


def _rel(a, b):
    a, b = (torch.as_tensor(np.asarray(x, np.float64)) for x in (a, b))
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("fault", FAULTS)
def test_fit_against_plain_reference(monkeypatch, fault):
    X, W0, H0 = _inputs()
    r = ref.ExpoReference(X, W0, H0, lam_y=1.0, weight_decay=0.01,
                          init_mu=0.01, device="cpu")
    for e in range(EPOCHS):
        r.epoch(e)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    m = ct.ExpoMF(num_components=K, lam_y=1.0, weight_decay=0.01,
                  chunk_size=64, device="cpu")
    m.W, m.H = W0, H0
    m.fit(X, num_epochs=EPOCHS, verbose=False)
    gaps = {"W": _rel(m.W, r.W), "H": _rel(m.H, r.H),
            "mu": _rel(m.mu, r.mu)}
    if fault == "none":
        assert max(gaps.values()) <= TOL, gaps
    else:
        assert max(gaps.values()) > TOL, gaps


def test_work_counts_the_least_model_work():
    """``work`` from the shapes and clicks alone: the symmetric Gramian
    R Co K (K + 1) and the rest of each half sweep, mu written."""
    X, W0, H0 = _inputs()
    r = ref.ExpoReference(X, W0, H0, lam_y=1.0, weight_decay=0.01,
                          init_mu=0.01, device="cpu")
    flops, nbytes = ref.work(r, X, {"num_components": K}, 2)
    Ru = int((np.diff(X.indptr) > 0).sum())
    Ri = int((np.diff(r.Xt.indptr) > 0).sum())
    p = X.nnz
    half = [2 * R * Co * K + 10 * R * Co + R * Co * K * (K + 1)
            + 2 * p * K + R * (K ** 3 / 3 + 2 * K * K)
            for R, Co in ((Ru, I), (Ri, U))]
    assert flops == pytest.approx(2 * sum(half))
    assert nbytes == pytest.approx(
        2 * (2 * ((U + I) * K + p) * 4 + (U + I) * K * 4 + I * 4))
