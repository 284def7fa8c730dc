"""The port's packed RelMF engine and trainer against ``cymf_tpu``'s.

The JAX side is pinned to the path the port copies: one device (the
conftest's 8-device mesh makes ``RelMF(packed="on")`` raise), the numpy
prep stream (``CYMF_TPU_PREP=numpy``) and, for whole fits, host prep
(``CYMF_TPU_RELMF_PREP=host``); its Pallas kernels run in interpret mode.
Tolerances:

- host streams and device windows: bit-equal;
- one epoch on identical streams: ``rtol 3e-3, atol 3e-4`` on the tables
  (the Adam drift class of ``tests/test_relmf.py``'s packed-epoch test:
  float32 sums in another order through Adam's first-touch division) and
  ``rtol 1e-4`` on the loss;
- the device-prep step body fed the host stream's cells: bit-equal to the
  host body (one body, two sources);
- whole host-prep fits: as ``tests/test_torch_bpr.py``, ``rtol 1e-3,
  atol 1e-4`` under sgd, and under Adam 99% of elements to that and
  every element within ``3 lr``.

The device-prep draws come from a ``torch.Generator``, not threefry, so
device-prep fits are held to host-prep fits by ranking quality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.ops import packed as jpk
from cymf_tpu.ops import packed_epoch as jpe
from cymf_tpu.ops import relmf_epoch as jre
from cymf_tpu.ops.sorted_accum import window_ranges
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import from_arrays, packed_state_from_jax
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.models import relmf as relmf_model
from cymf_tpu_torch.models.sgd import epoch_generator
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import packed_epoch as tpe
from cymf_tpu_torch.ops.hashset import (build_pair_hashset,
                                        hashset_contains, to_device)
from cymf_tpu_torch.ops import relmf_epoch as tre

# the setup of tests/test_relmf.py::TestPackedRelMF (packed epoch)
U, I, K, B, S, WROWS = 210, 140, 12, 1024, 3, 16
LR, WD, M = 0.02, 0.01, 0.1


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


@pytest.fixture
def jax_host_numpy(monkeypatch):
    # both packages on the numpy stream: the JAX side falls back to it
    # where its extension is not built, and the port's default is native
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                    density=0.08, seed=11)


def _problem(seed=3):
    rng = np.random.default_rng(seed)
    W0 = (rng.normal(size=(U, K)) * 0.1).astype(np.float32)
    H0 = (rng.normal(size=(I, K)) * 0.1).astype(np.float32)
    pos = rng.random((U, I)) < 0.08
    pu, pi = np.nonzero(pos)
    pos_keys = np.sort(pu.astype(np.int64) * I + pi)
    col_mean = pos.mean(axis=0)
    props = np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5
    rw = jpk.packed_rows(U, K, multiple=WROWS)
    rh = jpk.logical_rows(I, multiple=WROWS)
    invp = np.zeros((rh, 1), np.float32)
    invp[:I, 0] = 1.0 / np.maximum(props, M)
    return W0, H0, pos_keys, (pu, pi), invp, rw, rh


def test_prep_bit_equal(monkeypatch):
    # the numpy branch on both sides (the port's default is native)
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    _, _, pos_keys, _, _, rw, rh = _problem()
    args = (7, 1, S, B, U, I, K, rw, rh, WROWS, WROWS, pos_keys)
    got = tre.prep_relmf_epoch(*args)
    want = jre.prep_relmf_epoch(*args)
    assert 0 < got[2].sum() < got[2].size          # both labels occur
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_window_ranges_device_matches_host():
    """The cases of tests/test_relmf.py: skewed draws, empty windows and
    the chunk-overrun re-anchor."""
    rng = np.random.default_rng(0)
    for Bs, r_pad, wrows in ((1024, 512, 256), (2048, 1024, 256),
                             (4096, 256, 256), (1024, 2048, 256)):
        for trial in range(4):
            rows = np.sort(rng.integers(
                0, max(r_pad // (trial + 1), 1), Bs)).astype(np.int32)
            hs, hc = window_ranges(rows, r_pad, wrows, 1024, align=128)
            ds, dc = tre.window_ranges_device(torch.from_numpy(rows), r_pad,
                                              wrows, 1024)
            assert ds.dtype == dc.dtype == torch.int32
            np.testing.assert_array_equal(ds.numpy(), hs)
            np.testing.assert_array_equal(dc.numpy(), hc)


def _host_streams(pos_keys, rw, rh, seed=7):
    return tre.prep_relmf_epoch(seed, 0, S, B, U, I, K, rw, rh, WROWS,
                                WROWS, pos_keys)


def _torch(*arrays):
    """Tensors holding copies: the epochs update tables in place."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_epoch_matches_jax(opt):
    W0, H0, pos_keys, _, invp, rw, rh = _problem()
    u2, i2, lab, winw, si, rowsi, wini = _host_streams(pos_keys, rw, rh)
    Wp0 = jpk.pack_array(W0, K, multiple=WROWS)
    Hp0 = jpk.pack_logical(H0, K, multiple=WROWS)
    kw = dict(opt_name=opt, lr=LR, weight_decay=WD, K=K, rw=rw, rh=rh,
              wrows_w=WROWS, wrows_h=WROWS)
    jopt = jpe.make_packed_optimizer(opt, LR)
    Wj, Hj, owj, ohj, lj = jre.packed_relmf_epoch(
        jnp.asarray(Wp0), jnp.asarray(Hp0), jopt.init(jnp.asarray(Wp0)),
        jopt.init(jnp.asarray(Hp0)),
        *(jnp.asarray(a) for a in (u2, i2, lab, si, rowsi, wini, winw,
                                   invp)),
        jnp.asarray(float(S * B), jnp.float32), interpret=True, **kw)

    # the port starts from the JAX engine's exact state
    jopt0 = jpe.make_packed_optimizer(opt, LR)
    Wp, Hp, ow, oh = packed_state_from_jax(
        Wp0, Hp0, jax.device_get(jopt0.init(jnp.asarray(Wp0))),
        jax.device_get(jopt0.init(jnp.asarray(Hp0))), "cpu")
    _kernels.reset_launches()
    lt = tre.packed_relmf_epoch(
        Wp, Hp, ow, oh, *_torch(u2, i2, lab, si, rowsi, wini, winw, invp),
        float(S * B), **kw)
    assert dict(_kernels.launches) == {}           # plain versions on CPU
    tol = dict(rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), **tol)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hj), **tol)
    for k in owj:
        np.testing.assert_allclose(ow[k].numpy(), np.asarray(owj[k]), **tol)
        np.testing.assert_allclose(oh[k].numpy(), np.asarray(ohj[k]), **tol)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    assert not np.allclose(Wp.numpy(), Wp0)
    assert not np.allclose(Hp.numpy(), Hp0)


def test_device_step_matches_host_body():
    """The device-prep step, fed the host stream's cells with the users
    in a random order (each user's cells kept in stream order, so the
    stable sort restores the host order), equals the host epoch bit for
    bit: its sort, windows and lane-K propensities rebuild the host
    streams."""
    W0, H0, pos_keys, (pu, pi), invp, rw, rh = _problem()
    u2, i2, lab, winw, si, rowsi, wini = _host_streams(pos_keys, rw, rh)
    Wp0 = jpk.pack_array(W0, K, multiple=WROWS)
    Hp0 = jpk.pack_logical(H0, K, multiple=WROWS)
    kw = dict(weight_decay=WD, K=K, rw=rw, rh=rh, wrows_w=WROWS,
              wrows_h=WROWS)

    Wh, Hh = _torch(Wp0, Hp0)
    opt = tpe.make_packed_optimizer("adam", LR)
    owh, ohh = opt.init(Wh), opt.init(Hh)
    lh = tre.packed_relmf_epoch(
        Wh, Hh, owh, ohh, *_torch(u2, i2, lab, si, rowsi, wini, winw, invp),
        float(S * B), opt_name="adam", lr=LR, **kw)

    Wd, Hd = _torch(Wp0, Hp0)
    Hd[:, K] = torch.from_numpy(invp[:, 0])
    owd, ohd = opt.init(Wd), opt.init(Hd)
    rng = np.random.default_rng(0)
    loss = torch.zeros(())
    for t in range(S):
        order = np.lexsort((np.arange(B), rng.random(U)[u2[t]]))
        u, i, lb = _torch(u2[t][order], i2[t][order], lab[t][order])
        loss += tre.device_step(Wd, Hd, owd, ohd, opt, u, i, lb.bool(),
                                **kw)
    np.testing.assert_array_equal(Wd.numpy(), Wh.numpy())
    np.testing.assert_array_equal(Hd[:, :K].numpy(), Hh[:, :K].numpy())
    np.testing.assert_array_equal(Hd[:, K].numpy(), invp[:, 0])
    assert float(loss / float(S * B)) == float(lh)
    # and the hash set labels those cells as the host stream does
    hs = to_device(build_pair_hashset(pu, pi), "cpu")
    got = hashset_contains(hs, *_torch(u2.ravel(), i2.ravel()))
    np.testing.assert_array_equal(got.numpy(), lab.ravel().astype(bool))


def test_draw_cells_uniform_and_labelled():
    """Device-prep draws: in range, both labels at about the data's
    density, deterministic per generator seed."""
    _, _, _, (pu, pi), _, _, _ = _problem()
    hs = to_device(build_pair_hashset(pu, pi), "cpu")
    draws = [tre.draw_cells(epoch_generator(5, 2, "cpu"), 4096, U, I,
                            hs) for _ in range(2)]
    (u, i, lab), (u2, i2, lab2) = draws
    assert u.dtype == i.dtype == torch.int32 and lab.dtype == torch.bool
    assert torch.equal(u, u2) and torch.equal(i, i2)
    assert 0 <= int(u.min()) and int(u.max()) < U
    assert 0 <= int(i.min()) and int(i.max()) < I
    density = len(pu) / (U * I)
    assert abs(float(lab.float().mean()) - density) < 0.02
    other = tre.draw_cells(epoch_generator(5, 3, "cpu"), 4096, U, I, hs)
    assert not torch.equal(other[0], u)


@pytest.mark.parametrize("opt,lr", [("sgd", 0.05), ("adam", 0.01)])
def test_host_prep_fit_matches_jax(data, jax_host_numpy, opt, lr):
    kw = dict(num_components=10, learning_rate=lr, optimizer=opt,
              weight_decay=0.01, batch_size=4096)
    mj = cymf_tpu.RelMF(packed="on", **kw)
    mj.fit(data.train, num_epochs=2, verbose=False, seed=3)
    assert mj.packed_engine_ and mj.prep_backend_ == "numpy"
    mt = ct.RelMF(device="cpu", **kw)
    mt.fit(data.train, num_epochs=2, verbose=False, seed=3)
    assert mt.packed_engine_ and mt.prep_backend_ == "numpy"
    assert mt._samples_per_epoch == mj._samples_per_epoch == 15 * 4096
    assert set(mt.epoch_times_[0]) == {"prep_s", "device_s"}
    for got, want in ((mt.W, mj.W), (mt.H, mj.H)):
        assert got.shape == want.shape and got.dtype == np.float32
        if opt == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        else:
            off = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
            assert off.mean() <= 0.01, off.mean()
            assert np.abs(got - want).max() <= 3 * lr
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-3)


def test_device_prep_fit_learns_and_repeats(data, monkeypatch):
    """Device prep (the default) reaches 0.8x the host-prep fit's test
    DCG@5 (the bar of tests/test_relmf.py's device-prep test) and repeats
    itself exactly for a repeated seed."""
    ev = ct.AoaEvaluator(data.test, data.train, metrics=["DCG"], k=5,
                         device="cpu")
    kw = dict(num_components=10, learning_rate=0.01, batch_size=4096,
              device="cpu")
    monkeypatch.delenv("CYMF_TPU_RELMF_PREP", raising=False)
    fits = []
    for _ in range(2):
        m = ct.RelMF(**kw)
        m.fit(data.train, num_epochs=8, verbose=False, seed=3)
        fits.append(m)
    assert fits[0].prep_backend_ == "device-torch"
    assert set(fits[0].epoch_times_[0]) == {"device_s"}
    np.testing.assert_array_equal(fits[0].W, fits[1].W)
    np.testing.assert_array_equal(fits[0].H, fits[1].H)
    dcg_dev = ev.evaluate(fits[0].W, fits[0].H)["DCG@5"]
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    mh = ct.RelMF(**kw)
    mh.fit(data.train, num_epochs=8, verbose=False, seed=3)
    dcg_host = ev.evaluate(mh.W, mh.H)["DCG@5"]
    assert dcg_dev > 0.8 * dcg_host, (dcg_dev, dcg_host)
    assert dcg_host > 0.15 and np.isfinite(fits[0].last_loss)


def test_warm_start_and_from_arrays(data):
    m = ct.RelMF(8, learning_rate=0.02, batch_size=4096, device="cpu")
    m.fit(data.train, num_epochs=1, verbose=False)
    W1, H1 = m.W.copy(), m.H.copy()
    m.fit(data.train, num_epochs=0, verbose=False)
    np.testing.assert_array_equal(m.W, W1)        # kept, not re-initialized
    m2 = from_arrays(ct.RelMF, W1, H1, batch_size=4096, device="cpu")
    assert isinstance(m2, ct.RelMF) and m2.num_components == 8
    m2.fit(data.train, num_epochs=0, verbose=False)
    np.testing.assert_array_equal(m2.H, H1)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(update_mode="fast"), ValueError),
    (dict(engine="cuda"), ValueError),
    (dict(packed="yes"), ValueError),
    (dict(packed="on", engine="pallas"), ValueError),
    (dict(optimizer="rmsprop"), Exception),
    (dict(engine="pallas"), ValueError),          # past the engine's gate
])
def test_invalid_arguments(kwargs, exc):
    """Each raises when built or, on an ML-20M-sized catalog, when fit."""
    rng = np.random.default_rng(0)
    X = sparse.coo_matrix(
        (np.ones(5000), (rng.integers(0, 150000, 5000),
                         rng.integers(0, 30000, 5000))),
        shape=(150000, 30000)).tocsr()
    with pytest.raises(exc):
        ct.RelMF(device="cpu", **kwargs).fit(X, num_epochs=1)


def test_fit_gates(monkeypatch):
    X = sparse.random(40, 30, density=0.2, random_state=0, format="csr")
    X.data[:] = 1.0
    Xn = X.copy()
    Xn.data[:] = 3.0                                 # not binarized
    for m, Xf in ((ct.RelMF(8, device="cpu"), Xn),          # non-binary
                  (ct.RelMF(127, device="cpu"), X),
                  (ct.RelMF(8, packed="off", device="cpu"), X)):
        m.fit(Xf, num_epochs=1)                      # the batch engine
        assert m.packed_engine_ is False and np.isfinite(m.last_loss)
        assert m._samples_per_epoch == -(-40 * 30 // 8192) * 8192
    with pytest.raises(ValueError, match="binarized"):
        ct.RelMF(8, packed="on", device="cpu").fit(Xn, num_epochs=1)
    with pytest.raises(NotImplementedError, match="checkpointing"):
        ct.RelMF(8, engine="pallas", device="cpu").fit(
            X, checkpoint_path="m.npz")
    with pytest.raises(ValueError):
        ct.RelMF(8, device="cpu").fit(X, early_stopping=True)
    with pytest.raises(ValueError):
        ct.RelMF(8, device="cpu").fit(None)
    # the host-prep cap, and none under device prep
    m = ct.RelMF(8, packed="on", device="cpu")
    assert m._packed_engine(True, 1 << 40) is True
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    cap = relmf_model.HOST_PREP_MAX_CELLS
    assert m._packed_engine(True, cap) is True
    with pytest.raises(ValueError, match=f"at most {cap} cells"):
        m._packed_engine(True, cap + 1)
    assert ct.RelMF(8, device="cpu")._packed_engine(True, cap + 1) is False
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "fast")
    with pytest.raises(ValueError, match="device|host"):
        m._packed_engine(True, 10)
