"""The port's wide BPR engine (K >= 128) against the JAX package's.

Host helpers and the static prep must be bit-equal.  One epoch on
identical streams from identical state (``wide_state_from_jax``), the JAX
side's count-lane accumulations in interpret mode at
``precision="highest"``, must agree to ``tests/test_packed_accum.py``'s
``rtol 2e-4, atol 2e-5`` (float32 sums in another order, through an
optimizer), the loss to ``1e-5`` relative.  The fits run the JAX
package's ``_fit_wide`` (``packed="on"``, one device, the numpy prep
stream, its default "split" precision: bf16 hi+lo, about 2^-16 relative)
against ``ct.BPR`` on the CPU: ``rtol 1e-3, atol 1e-4`` under sgd; under
Adam at least 99% of elements within that and every element within ``3
lr`` (the first-touch drift class of ``tests/test_torch_bpr.py``).
Padding lanes ``[K, Kp)`` stay exactly zero under every optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.ops import packed_epoch as jpe
from cymf_tpu.ops import wide_epoch as jwe
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import wide_state_from_jax
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import packed_epoch as tpe
from cymf_tpu_torch.ops import wide_epoch as twe

U, I, K, B, S, WROWS = 300, 200, 160, 1024, 2, 128
LR, WD = 0.02, 0.01


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


@pytest.fixture(autouse=True)
def _jax_numpy(monkeypatch):
    # both packages on the numpy stream: the JAX side falls back to it
    # where its extension is not built, and the port's default is native
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")


@pytest.mark.parametrize("k", [1, 127, 128, 129, 160, 256, 300])
def test_widths_and_rows_equal(k):
    assert twe.kp_width(k) == jwe.kp_width(k)
    for n in (1, 511, 512, 513, 138493):
        assert twe.wide_rows(n) == jwe.wide_rows(n)
        assert twe.wide_rows(n, 128) == jwe.wide_rows(n, 128)


def test_pack_wide_bit_equal():
    rng = np.random.default_rng(0)
    for k in (128, 160, 300):
        table = rng.normal(size=(37, k))
        got, want = twe.pack_wide(table, k, 128), jwe.pack_wide(table, k, 128)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _streams(seed=3):
    """User-sorted steps with a padded tail (PAD_USER) and their prep."""
    rng = np.random.default_rng(seed)
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    u2[-1, -100:] = np.int32(2**31 - 1)
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    i2[-1, -100:] = 0
    live = u2 < U
    pos_keys = np.sort(u2[live].astype(np.int64) * I + i2[live])
    return u2, i2, pos_keys


def test_prep_bit_equal():
    u2, i2, pos_keys = _streams()
    rw, rh = twe.wide_rows(U, WROWS), twe.wide_rows(I, WROWS)
    got = twe.prep_static_wide(u2, i2, rw, rh, WROWS)
    want = jwe.prep_static_wide(u2, i2, rw, rh, WROWS)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    j2, mask, sj, _, _ = tpe.prep_epoch(np.random.default_rng(9), u2, i2,
                                        pos_keys, U, I, K, rh, WROWS)
    assert mask.sum() < mask.size - 100          # some samples masked
    for g, w in zip(twe.wide_sorted_masks(mask, got[2], sj),
                    jwe.wide_sorted_masks(mask, want[2], sj)):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_epoch_matches_jax(opt):
    u2, i2, pos_keys = _streams()
    rw, rh = twe.wide_rows(U, WROWS), twe.wide_rows(I, WROWS)
    rowsu, winw, si, rowsi, wini = jwe.prep_static_wide(u2, i2, rw, rh,
                                                        WROWS)
    j2, mask, sj, rowsj, winj = jpe.prep_epoch(
        np.random.default_rng(9), u2, i2, pos_keys, U, I, K, rh, WROWS)
    mi2, mj2 = jwe.wide_sorted_masks(mask, si, sj)
    streams = (u2, i2, rowsu, winw, si, rowsi, wini, j2, mask, sj, rowsj,
               winj, mi2, mj2)
    rng = np.random.default_rng(5)
    W0 = jwe.pack_wide(rng.normal(size=(U, K)) * 0.1, K, WROWS)
    H0 = jwe.pack_wide(rng.normal(size=(I, K)) * 0.1, K, WROWS)
    n_valid = S * B
    kw = dict(opt_name=opt, lr=LR, weight_decay=WD, K=K, rw=rw, rh=rh,
              wrows=WROWS)
    jopt = jpe.make_packed_optimizer(opt, LR)
    owj, ohj = jopt.init(jnp.asarray(W0)), jopt.init(jnp.asarray(H0))
    W, H, ow, oh = wide_state_from_jax(
        W0, H0, jax.device_get(owj), jax.device_get(ohj), "cpu")
    Wj, Hj, owj, ohj, lj = jwe.wide_bpr_epoch(
        jnp.asarray(W0), jnp.asarray(H0), owj, ohj,
        *(jnp.asarray(a) for a in streams), jnp.asarray(n_valid),
        interpret=True, precision="highest", **kw)

    _kernels.reset_launches()
    lt = twe.wide_bpr_epoch(
        W, H, ow, oh,
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in streams),
        n_valid, **kw)
    assert not _kernels.launches                # the CPU runs plain
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **tol)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), **tol)
    assert set(ow) == set(owj) and set(oh) == set(ohj)
    for k in owj:
        np.testing.assert_allclose(ow[k].numpy(), np.asarray(owj[k]), **tol)
        np.testing.assert_allclose(oh[k].numpy(), np.asarray(ohj[k]), **tol)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # both tables moved; padding lanes and rows stayed zero
    assert not np.allclose(W.numpy()[:U, :K], W0[:U, :K])
    assert not np.allclose(H.numpy()[:I, :K], H0[:I, :K])
    assert not W[:, K:].any() and not H[:, K:].any()
    assert not W[U:].any() and not H[I:].any()


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                    density=0.08, seed=11)


@pytest.mark.parametrize("k,opt,lr", [(128, "sgd", 0.05), (128, "adam", 0.01),
                                      (160, "sgd", 0.05), (160, "adam", 0.01)])
def test_fit_matches_jax(data, k, opt, lr):
    kw = dict(num_components=k, learning_rate=lr, optimizer=opt,
              weight_decay=0.01)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        mj = cymf_tpu.BPR(packed="on", **kw)
        mj.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mj.prep_backend_ == "numpy"
    mt = ct.BPR(device="cpu", **kw)
    mt.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mt.prep_backend_ == "numpy" and len(mt.epoch_times_) == 2
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


def test_fit_learns_and_warm_starts():
    """The wide fit trains end to end (``tests/test_packed_accum.py``'s
    ``test_fit_wide_on_learns``)."""
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(150, 4)) @ rng.normal(size=(4, 90))
    X = sp.csr_matrix((scores > np.quantile(scores, 0.9)).astype(np.float64))
    m = ct.BPR(num_components=128, learning_rate=0.05, weight_decay=0.0,
               batch_size=1024, device="cpu")
    m.fit(X, num_epochs=3, verbose=False)
    first_loss = m.last_loss
    m.fit(X, num_epochs=3, verbose=False)          # warm start continues
    assert m.last_loss < first_loss
    ev = ct.AoaEvaluator(X, metrics=["DCG"], k=5, num_negatives=50,
                         device="cpu")
    assert ev.evaluate(m.W, m.H)["DCG@5"] > 0.3

