"""The port's BPR trainer as a whole, against ``cymf_tpu.BPR``.

The JAX side runs ``_fit_packed`` on one device with the numpy prep
stream, its Pallas kernels in interpret mode: pinned to the v4 pipeline,
unpinned (both packages pick v5 on this small catalog), forced to v7 by
``CYMF_TPU_PACKED_KERNEL=7``, and with ``neg_pool`` (v8).  Both packages
replay the same init, shuffle and negative streams, so after two epochs
the tables agree up to the JAX fit's bf16 hi+lo ("split") expansion and
accumulation, about 2^-16 relative per value: ``rtol 1e-3, atol 1e-4``
for sgd.  Under Adam an element whose first update lands near zero can take
the other sign and move by up to ~2 lr (the first-touch drift class of
the JAX package's own parity tests): at least 99% of elements agree to
that tolerance and every element within ``3 lr``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import bpr_from_arrays
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.ops.packed_epoch import make_packed_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU fits issue many small ops; when the suite runs in
    parallel workers, torch's intra-op threads oversubscribe the cores and
    slow such a test many times over.  One thread a test, restored after
    (it changes no result this file checks)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                    density=0.08, seed=11)


@pytest.fixture
def jax_numpy(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


@pytest.fixture
def jax_v4_numpy(jax_numpy, monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", "4")


@pytest.mark.parametrize("opt,lr", [("sgd", 0.05), ("adam", 0.01)])
def test_fit_matches_jax(data, jax_v4_numpy, opt, lr):
    kw = dict(num_components=12, learning_rate=lr, optimizer=opt,
              weight_decay=0.01)
    mj = cymf_tpu.BPR(packed="on", **kw)
    mj.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mj.packed_kernel_ == 4 and mj.prep_backend_ == "numpy"
    mt = ct.BPR(device="cpu", **kw)
    mt.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mt.packed_kernel_ == 4 and mt.prep_backend_ == "numpy"
    for got, want in ((mt.W, mj.W), (mt.H, mj.H)):
        assert got.shape == want.shape and got.dtype == np.float32
        if opt == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        else:
            off = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
            assert off.mean() <= 0.01, off.mean()
            assert np.abs(got - want).max() <= 3 * lr
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-3)


@pytest.mark.parametrize("opt,lr,force,pool,want", [
    ("sgd", 0.05, "", 0, 5),        # the data gate's choice on this catalog
    ("adam", 0.01, "", 0, 5),
    ("sgd", 0.05, "7", 0, 7),       # forced, as in the JAX package
    ("sgd", 0.05, "", 128, 8),      # the shared negative pool
])
def test_fit_pipelines_match_jax(data, jax_numpy, monkeypatch, opt, lr,
                                 force, pool, want):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", force)
    kw = dict(num_components=12, learning_rate=lr, optimizer=opt,
              weight_decay=0.01, neg_pool=pool)
    mj = cymf_tpu.BPR(packed="on", **kw)
    mj.fit(data.train, num_epochs=2, verbose=False, seed=5)
    mt = ct.BPR(device="cpu", **kw)
    mt.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mj.packed_kernel_ == mt.packed_kernel_ == want
    assert mj.prep_backend_ == mt.prep_backend_ == "numpy"
    for got, want_t in ((mt.W, mj.W), (mt.H, mj.H)):
        assert got.shape == want_t.shape
        if opt == "sgd":
            np.testing.assert_allclose(got, want_t, rtol=1e-3, atol=1e-4)
        else:
            off = np.abs(got - want_t) > 1e-4 + 1e-3 * np.abs(want_t)
            assert off.mean() <= 0.01, off.mean()
            assert np.abs(got - want_t).max() <= 3 * lr
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-3)


def test_fit_takes_v4_on_sparse_streams():
    """A batch spread over a large user table spans more packed rows per
    chunk than any expansion window: the gate keeps v4, as in JAX."""
    from cymf_tpu.ops.packed_epoch import engine_version as jax_version
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import packed as pk
    X = _ml20m_sized()
    m = ct.BPR(20, device="cpu")
    m.fit(X, num_epochs=1, verbose=False)
    assert m.packed_kernel_ == 4
    np.random.seed(0)
    u2, _ = sorted_batches(*shuffled_interactions(X), 1024)
    rw = pk.packed_rows(X.shape[0], 20, multiple=256)
    assert jax_version(20, rw, 256, u2=u2) == 4


def test_pool_quickstart_learns():
    """``BPR(neg_pool=128)`` trains to a sane DCG (the JAX package's
    ``tests/test_packed_pool.py::test_pool_fit_learns``)."""
    d = SyntheticImplicitDataset(num_user=400, num_item=200, rank=5,
                                 density=0.1, seed=11)
    ev = ct.AoaEvaluator(d.test, d.train, metrics=["DCG"], k=5, device="cpu")
    m = ct.BPR(num_components=20, learning_rate=0.02, weight_decay=0.01,
               neg_pool=128, device="cpu")
    m.fit(d.train, num_epochs=12, verbose=False, seed=3)
    assert m.packed_kernel_ == 8 and m.prep_backend_ == "numpy"
    dcg = ev.evaluate(m.W, m.H)["DCG@5"]
    assert dcg > 0.2, dcg


class _Recording(ct.AoaEvaluator):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.history = []

    def evaluate(self, W, H, seed=1234):
        res = super().evaluate(W, H, seed)
        self.history.append(res["DCG@5"])
        return res


def test_quickstart_learns_and_restores_best_epoch(data):
    valid = _Recording(data.valid, data.train, metrics=["DCG"], k=5,
                       device="cpu")
    test = ct.AoaEvaluator(data.test, data.train, k=5, device="cpu")
    m0 = ct.BPR(10, learning_rate=0.05, device="cpu")
    m0.fit(data.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]

    m = ct.BPR(10, learning_rate=0.05, device="cpu")
    m.fit(data.train, num_epochs=40, valid_evaluator=valid,
          early_stopping=True, verbose=False)
    h = valid.history
    best = int(np.argmax(h))
    # the reference's rule: stop on the 12th epoch after the best that
    # does not improve on it (`bpr.pyx:173-183`)
    assert len(h) == best + 13 < 40
    assert m.valid_dcg == h[best]
    # the best epoch's tables are restored
    assert valid.evaluate(m.W, m.H)["DCG@5"] == h[best]
    assert test.evaluate(m.W, m.H)["DCG@5"] >= base + 0.1
    assert np.isfinite(m.last_loss)


def test_warm_start_continues(data):
    m = ct.BPR(10, learning_rate=0.05, device="cpu")
    m.fit(data.train, num_epochs=2, verbose=False)
    W1, H1, loss1 = m.W.copy(), m.H.copy(), m.last_loss
    m.fit(data.train, num_epochs=0, verbose=False)
    np.testing.assert_array_equal(m.W, W1)        # kept, not re-initialized
    np.testing.assert_array_equal(m.H, H1)
    m.fit(data.train, num_epochs=2, verbose=False)
    assert m.last_loss < loss1
    # a hand-set table is what the next fit starts from
    m2 = bpr_from_arrays(W1, H1, learning_rate=0.05, device="cpu")
    m2.fit(data.train, num_epochs=0, verbose=False)
    np.testing.assert_array_equal(m2.W, W1)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(update_mode="fast"), ValueError),
    (dict(engine="cuda"), ValueError),
    (dict(packed="yes"), ValueError),
    (dict(packed="on", engine="pallas"), ValueError),
    (dict(neg_pool=100), ValueError),
    (dict(neg_pool=4096), ValueError),
    (dict(neg_pool=256, packed="off"), ValueError),
    (dict(optimizer="rmsprop"), Exception),
    (dict(engine="pallas"), ValueError),          # past the engine's gate
    (dict(packed="off"), NotImplementedError),
    (dict(neg_pool=256, num_components=31), ValueError),   # s (K + 1) = 128
    (dict(num_components=128), NotImplementedError),
])
def test_invalid_arguments(kwargs, exc):
    """Each raises when built or, on an ML-20M-sized catalog, when fit."""
    with pytest.raises(exc):
        ct.BPR(device="cpu", **kwargs).fit(_ml20m_sized(), num_epochs=1,
                                           verbose=False)


def _ml20m_sized():
    """5,000 interactions in a 150,000 x 30,000 matrix: past the
    sequential engine's gate (tests/test_pallas_engine.py's case)."""
    rng = np.random.default_rng(0)
    return sparse.coo_matrix(
        (np.ones(5000), (rng.integers(0, 150000, 5000),
                         rng.integers(0, 30000, 5000))),
        shape=(150000, 30000)).tocsr()


def test_default_device_is_the_card():
    """No fallback that hides the device: without a device the port names
    the card, visible or not, and fails at its first allocation there."""
    from cymf_tpu_torch import config
    assert config.default_device() == torch.device("cuda", 0)
    assert ct.BPR().device == torch.device("cuda", 0)


def test_invalid_fit_arguments(data):
    m = ct.BPR(8, device="cpu")
    with pytest.raises(ValueError):
        m.fit(None)
    with pytest.raises(ValueError):
        m.fit("not a matrix")
    with pytest.raises(ValueError):
        m.fit(data.train, early_stopping=True)
    with pytest.raises(NotImplementedError):
        m.fit(data.train, checkpoint_path="model.npz")
    with pytest.raises(Exception, match="invalid"):
        make_packed_optimizer("lbfgs", 0.1)


def test_dense_input_accepted():
    X = (np.random.default_rng(0).random((50, 40)) < 0.2).astype(float)
    m = ct.BPR(6, device="cpu")
    m.fit(X, num_epochs=1, verbose=False)
    assert m.W.shape == (50, 6) and m.H.shape == (40, 6)
    assert np.isfinite(m.W).all() and np.isfinite(m.last_loss)


def test_load_reads_a_model_saved_by_jax(tmp_path):
    rng = np.random.default_rng(2)
    mj = cymf_tpu.BPR(7, learning_rate=0.03, weight_decay=0.02)
    mj.W = rng.normal(size=(30, 7)).astype(np.float32)
    mj.H = rng.normal(size=(20, 7)).astype(np.float32)
    path = str(tmp_path / "bpr.npz")
    mj.save(path)
    mt = ct.BPR.load(path, device="cpu")
    assert (mt.num_components, mt.learning_rate, mt.weight_decay) == \
        (7, 0.03, 0.02)
    np.testing.assert_array_equal(mt.W, mj.W)
    np.testing.assert_array_equal(mt.H, mj.H)
    # and the other way round
    mt.save(str(tmp_path / "back.npz"))
    back = cymf_tpu.BPR.load(str(tmp_path / "back.npz"))
    np.testing.assert_array_equal(back.W, mj.W)
    X = sparse.random(30, 20, density=0.2, random_state=0, format="csr")
    mt.fit(X, num_epochs=1, verbose=False)       # warm start from the load
    assert mt.W.shape == (30, 7)


def test_import_leaves_jax_and_sklearn_stack_out():
    """``import cymf_tpu_torch`` (and every module of it) must not pull in
    jax, sklearn, tqdm or pandas.  The baseline is what torch, numpy and
    scipy import on their own (torch may import tqdm where installed)."""
    code = (
        "import sys, importlib, pkgutil, numpy, scipy.sparse, torch\n"
        "before = set(sys.modules)\n"
        "import cymf_tpu_torch\n"
        "from cymf_tpu_torch import GloVe, RelMF\n"
        "for m in pkgutil.walk_packages(cymf_tpu_torch.__path__,\n"
        "                               'cymf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "print(sorted(new & {'jax', 'jaxlib', 'sklearn', 'tqdm', "
        "'pandas', 'cymf_tpu'}))\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "('cymf_tpu_torch.models.', 'cymf_tpu_torch.ops.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    jax_stack, modules = out.stdout.strip().splitlines()
    assert jax_stack == "[]"
    for m in ("models.wmf", "models.expomf", "ops.als", "ops.chol_kernel",
              "models.relmf", "models.glove", "ops.relmf_epoch",
              "ops.glove_epoch", "ops.hashset"):
        assert f"'cymf_tpu_torch.{m}'" in modules
