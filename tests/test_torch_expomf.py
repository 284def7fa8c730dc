"""The port's ExpoMF trainer as a whole, against ``cymf_tpu.ExpoMF``.

Both fits start from the same seed-4321 randn init and run on one device
(the JAX side on a 1-device mesh, its single-device branch).  ``W``, ``H``
and ``mu`` agree to ``rtol 2e-3, atol 2e-4``, the JAX package's tolerance
between solver forms.  At K=128 the fit uses ``weight_decay=0.1``: with
the default 0.01 the JAX package's own dense and blocked Cholesky forms
drift apart beyond that tolerance by the second epoch (the ridge
``wd / lam_y`` sets the conditioning, and float32 round-off grows with
it), so the comparison would test the conditioning, not the port.
"""

import jax
import numpy as np
import pytest
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.utils.checkpoint import save_checkpoint

TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=60, num_item=40, rank=4,
                                    density=0.15, seed=9)


@pytest.fixture
def one_device(monkeypatch):
    for v in ("CYMF_TPU_ALS_CHOL", "CYMF_TPU_ALS_CHOL_BLOCK"):
        monkeypatch.delenv(v, raising=False)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield monkeypatch


@pytest.mark.parametrize("X,kw", [
    ("data", dict(num_components=8, weight_decay=0.05, chunk_size=16)),
    ("data", dict(num_components=8, solver="lu", prefactor=1.25)),
    ("sparse", dict(num_components=128, weight_decay=0.1)),
])
def test_fit_matches_jax(data, one_device, X, kw):
    X = sparse.csr_matrix(data.train) if X == "data" else sparse.random(
        300, 200, density=0.05, random_state=0, format="csr",
        data_rvs=lambda n: np.ones(n))
    mj = cymf_tpu.ExpoMF(**kw)
    mj.fit(X, num_epochs=2, verbose=False)
    mt = ct.ExpoMF(device="cpu", **kw)
    mt.fit(X, num_epochs=2, verbose=False)
    assert mt.prefactor == mj.prefactor
    for got, want in ((mt.W, mj.W), (mt.H, mj.H), (mt.mu, mj.mu)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


def test_empty_rows_zeroed_and_mu():
    X = np.zeros((6, 5))
    X[0, :3] = 1.0
    X[2, 1] = 1.0
    m = ct.ExpoMF(num_components=3, chunk_size=4, device="cpu")
    m.fit(sparse.csr_matrix(X), num_epochs=1, verbose=False)
    np.testing.assert_allclose(m.W[[1, 3, 4, 5]], 0.0)
    np.testing.assert_allclose(m.H[[3, 4]], 0.0)
    assert m.mu.shape == (5,) and np.isfinite(m.mu).all()
    assert (m.mu > 0).all() and (m.mu <= 1).all()


def test_learns_and_early_stopping_restores_best(data):
    valid = ct.AoaEvaluator(data.valid, data.train, metrics=["DCG"], k=5,
                            device="cpu")
    test = ct.AoaEvaluator(data.test, data.train, metrics=["DCG"], k=5,
                           device="cpu")
    m0 = ct.ExpoMF(8, device="cpu")
    m0.fit(data.train, num_epochs=0, verbose=False)
    m = ct.ExpoMF(8, device="cpu")
    m.fit(data.train, num_epochs=30, valid_evaluator=valid,
          early_stopping=True, verbose=False)
    assert valid.evaluate(m.W, m.H)["DCG@5"] == m.valid_dcg
    assert test.evaluate(m.W, m.H)["DCG@5"] > \
        test.evaluate(m0.W, m0.H)["DCG@5"] + 0.05


def test_invalid_arguments(data, tmp_path):
    with pytest.raises(ValueError):
        ct.ExpoMF(solver="qr")
    m = ct.ExpoMF(8, device="cpu")
    with pytest.raises(ValueError):
        m.fit("not a matrix")
    with pytest.raises(ValueError):
        m.fit(data.train, early_stopping=True)
    # a checkpoint of another schema (WMF's, without mu) is refused
    p = str(tmp_path / "wmf.npz")
    U, I = data.train.shape
    save_checkpoint(p, {"W": np.zeros((U, 8)), "H": np.zeros((I, 8))}, 0)
    with pytest.raises(KeyError, match="mu"):
        m.fit(data.train, checkpoint_path=p, resume=True)
