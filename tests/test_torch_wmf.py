"""The port's WMF trainer as a whole, against ``cymf_tpu.WMF``.

Both fits start from the same seed-4321 init and run on one device (the
JAX side on a 1-device mesh, its single-device branch).  Tolerance
``rtol 2e-3, atol 2e-4``, the JAX package's own between solver forms
(`tests/test_wmf.py`): float32 solves with sums in another order, whose
spread grows with the conditioning of ``A0 = Y^T Y + wd I``.
"""

import jax
import numpy as np
import pytest
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import from_arrays
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.utils.checkpoint import save_checkpoint

TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=90, num_item=70, rank=4,
                                    density=0.15, seed=2)


@pytest.fixture(scope="module")
def X128():
    return sparse.random(300, 200, density=0.05, random_state=0,
                         format="csr", data_rvs=lambda n: np.ones(n))


@pytest.fixture
def one_device(monkeypatch):
    for v in ("CYMF_TPU_ALS_CHOL", "CYMF_TPU_ALS_CHOL_BLOCK",
              "CYMF_TPU_ALS_WOODBURY"):
        monkeypatch.delenv(v, raising=False)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield monkeypatch


def _both(X, epochs=2, **kw):
    mj = cymf_tpu.WMF(**kw)
    mj.fit(X, num_epochs=epochs, verbose=False)
    mt = ct.WMF(device="cpu", **kw)
    mt.fit(X, num_epochs=epochs, verbose=False)
    return mj, mt


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
def test_fit_matches_jax_k8(data, one_device, solver):
    mj, mt = _both(sparse.csr_matrix(data.train), num_components=8,
                   weight_decay=0.05, weight=5.0, chunk_size=32,
                   solver=solver)
    for got, want in ((mt.W, mj.W), (mt.H, mj.H)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("woodbury", ["auto", "off"])
def test_fit_matches_jax_k128(X128, one_device, woodbury):
    """K=128, auto Cholesky: the blocked form on both sides, small-P
    chunks on Woodbury under ``auto``, all chunks standard under ``off``."""
    one_device.setenv("CYMF_TPU_ALS_WOODBURY", woodbury)
    mj, mt = _both(X128, num_components=128)
    assert mt.woodbury_max_p_ == mj.woodbury_max_p_
    wb = sum(mt.chunks_[s]["woodbury"] for s in "WH")
    std = sum(mt.chunks_[s]["standard"] for s in "WH")
    if woodbury == "auto":
        assert wb > 0
    else:
        assert wb == 0 and std > 0
    np.testing.assert_allclose(mt.W, mj.W, **TOL)
    np.testing.assert_allclose(mt.H, mj.H, **TOL)


def test_woodbury_on_matches_off(X128, one_device):
    out = {}
    for mode in ("on", "off"):
        one_device.setenv("CYMF_TPU_ALS_WOODBURY", mode)
        m = ct.WMF(num_components=16, chunk_size=128, device="cpu")
        m.fit(X128, num_epochs=3, verbose=False)
        out[mode] = m
    assert out["on"].chunks_["W"]["standard"] == 0
    assert out["off"].chunks_["W"]["woodbury"] == 0
    np.testing.assert_allclose(out["on"].W, out["off"].W, **TOL)
    np.testing.assert_allclose(out["on"].H, out["off"].H, **TOL)


@pytest.mark.parametrize("env,kw", [
    ({}, dict(num_components=128, weight_decay=1e-4)),
    ({}, dict(num_components=128)),
    ({"CYMF_TPU_ALS_CHOL": "xla"}, dict(num_components=128)),
    ({"CYMF_TPU_ALS_CHOL": "pallas"}, dict(num_components=128)),
    ({"CYMF_TPU_ALS_CHOL": "blocked", "CYMF_TPU_ALS_CHOL_BLOCK": "96"},
     dict(num_components=128)),
    ({}, dict(num_components=128, weight=1.0)),
    ({}, dict(num_components=64)),
    ({"CYMF_TPU_ALS_WOODBURY": "on"}, dict(num_components=8)),
    ({"CYMF_TPU_ALS_WOODBURY": "off"}, dict(num_components=128)),
])
def test_woodbury_max_p_matches_jax(one_device, env, kw):
    for k, v in env.items():
        one_device.setenv(k, v)
    X = sparse.random(60, 40, density=0.1, random_state=0, format="csr",
                      data_rvs=lambda n: np.ones(n))
    mj, mt = _both(X, epochs=1, **kw)
    assert mt.woodbury_max_p_ == mj.woodbury_max_p_


def test_invalid_arguments(data, one_device, tmp_path):
    with pytest.raises(ValueError):
        ct.WMF(solver="qr")
    m = ct.WMF(8, device="cpu")
    with pytest.raises(ValueError):
        m.fit(None)
    with pytest.raises(ValueError):
        m.fit(data.train, early_stopping=True)
    # a checkpoint of another width is refused
    p = str(tmp_path / "k4.npz")
    U, I = data.train.shape
    save_checkpoint(p, {"W": np.zeros((U, 4)), "H": np.zeros((I, 4))}, 0)
    with pytest.raises(ValueError, match="shape"):
        m.fit(data.train, checkpoint_path=p, resume=True)
    one_device.setenv("CYMF_TPU_ALS_WOODBURY", "maybe")
    with pytest.raises(ValueError, match="WOODBURY"):
        m.fit(data.train, num_epochs=1, verbose=False)
    one_device.setenv("CYMF_TPU_ALS_WOODBURY", "on")
    with pytest.raises(ValueError, match="weight > 1"):
        ct.WMF(8, weight=1.0, device="cpu").fit(data.train, verbose=False)


def test_empty_rows_zeroed():
    X = np.zeros((6, 5))
    X[0, :3] = 1.0
    X[2, 1] = 1.0
    m = ct.WMF(num_components=3, chunk_size=4, device="cpu")
    m.fit(sparse.csr_matrix(X), num_epochs=1, verbose=False)
    np.testing.assert_allclose(m.W[[1, 3, 4, 5]], 0.0)
    np.testing.assert_allclose(m.H[[3, 4]], 0.0)
    assert np.abs(m.W[[0, 2]]).min() > 0


class _Recording(ct.AoaEvaluator):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.history = []

    def evaluate(self, W, H, seed=1234):
        res = super().evaluate(W, H, seed)
        self.history.append(res["DCG@5"])
        return res


def test_learns_and_early_stopping_restores_best(data):
    valid = _Recording(data.valid, data.train, metrics=["DCG"], k=5,
                       device="cpu")
    test = ct.AoaEvaluator(data.test, data.train, k=5, device="cpu")
    m0 = ct.WMF(8, weight_decay=0.05, device="cpu")
    m0.fit(data.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.WMF(8, weight_decay=0.05, device="cpu")
    m.fit(data.train, num_epochs=40, valid_evaluator=valid,
          early_stopping=True, verbose=False)
    h = list(valid.history)
    best = int(np.argmax(h))
    assert len(h) == best + 13 < 40      # `bpr.pyx:173-183`
    assert len(m.epoch_times_) == len(h)
    assert m.valid_dcg == h[best]
    assert valid.evaluate(m.W, m.H)["DCG@5"] == h[best]
    assert test.evaluate(m.W, m.H)["DCG@5"] >= base + 0.1


def test_save_load_both_ways_and_warm_start(data, tmp_path, one_device):
    X = sparse.csr_matrix(data.train)
    mj = cymf_tpu.WMF(8, weight_decay=0.05, weight=4.0)
    mj.fit(X, num_epochs=1, verbose=False)
    mj.save(str(tmp_path / "jax.npz"))
    mt = ct.WMF.load(str(tmp_path / "jax.npz"), device="cpu")
    assert (mt.num_components, mt.weight_decay, mt.weight) == (8, 0.05, 4.0)
    np.testing.assert_array_equal(mt.W, mj.W)
    np.testing.assert_array_equal(mt.H, mj.H)
    mt.save(str(tmp_path / "port.npz"))
    back = cymf_tpu.WMF.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(back.W, mj.W)
    # both continue from the same state and agree
    mj.fit(X, num_epochs=1, verbose=False)
    mt2 = from_arrays(ct.WMF, back.W, back.H, weight_decay=0.05, weight=4.0,
                      device="cpu")
    mt2.fit(X, num_epochs=1, verbose=False)
    np.testing.assert_allclose(mt2.W, mj.W, **TOL)
    np.testing.assert_allclose(mt2.H, mj.H, **TOL)
