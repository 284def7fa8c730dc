"""The port's packed GloVe engine and trainer against ``cymf_tpu``'s.

The JAX side is pinned to the path the port copies: one device (on the
conftest's 8-device mesh ``GloVe(packed="on")`` takes its sharded form);
its Pallas kernels run in interpret mode.  Tolerances:

- the static host streams: bit-equal;
- one epoch from the same state on the same streams, and whole fits under
  the same ``np.random.seed``: tables ``rtol 2e-3, atol 2e-5`` and the
  loss ``rtol 1e-4``, the bound of ``tests/test_glove.py`` between the
  packed and the XLA engine (float32 sums in another order through
  AdaGrad);
- the constant-one columns: bit-exactly 1;
- the word2vec text of one table: identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.ops import glove_epoch as jge
from cymf_tpu.ops import packed as jpk
from cymf_tpu.ops.packed_epoch import PackedAdaGrad as JAdaGrad
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import packed_state_from_jax
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import glove_epoch as tge

V1, V2, K, S, B, WROWS = 90, 70, 8, 2, 1024, 16


@pytest.fixture
def one_device():
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


def _toy_cooc(V=120, seed=3):
    """The co-occurrence matrix of ``tests/test_glove.py``."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((V, V))
    mask = rng.random((V, V)) < 0.2
    dense[mask] = rng.integers(1, 50, size=mask.sum())
    np.fill_diagonal(dense, 0)
    return sparse.csr_matrix(dense)


def _streams(Kd=K, seed=0):
    """Two steps sorted by central id, the last 300 triples padding (the
    trainer's sentinel central id, context 0, count 1)."""
    rng = np.random.default_rng(seed)
    c2 = rng.integers(0, V1, (S, B)).astype(np.int32)
    c2[-1, -300:] = 2**31 - 1
    c2 = np.sort(c2, axis=1)
    x2 = rng.integers(0, V2, (S, B)).astype(np.int32)
    n2 = rng.integers(1, 40, (S, B)).astype(np.float64)
    x2[-1, -300:], n2[-1, -300:] = 0, 1.0
    Kp = Kd + 2
    rw = jpk.packed_rows(V1, Kp, multiple=WROWS)
    rh = jpk.logical_rows(V2, multiple=WROWS)
    return c2, x2, n2, rw, rh


def test_prep_glove_static_bit_equal():
    c2, x2, n2, rw, rh = _streams()
    args = (c2, x2, n2, V1, K, rw, rh, WROWS, WROWS, 10.0, 0.75)
    got = tge.prep_glove_static(*args)
    want = jge.prep_glove_static(*args)
    assert got[0].sum() == S * B - 300                  # padding is dead
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("Kd", [8, 50])
def test_packed_glove_epoch_matches_jax(Kd):
    """One epoch from the JAX engine's exact state (``packed_state_from_
    jax``) on the same streams, padding included; the slot counts of a
    narrow table (s = 12) and of GloVe's K = 50 (s = 2)."""
    c2, x2, n2, rw, rh = _streams(Kd)
    Kp = Kd + 2
    rng = np.random.default_rng(1)
    Zc_np, Zx_np = jge.augment_tables(
        rng.normal(size=(V1, Kd)) * 0.1, rng.normal(size=V1) * 0.1,
        rng.normal(size=(V2, Kd)) * 0.1, rng.normal(size=V2) * 0.1)
    Zc0 = jpk.pack_array(Zc_np.astype(np.float32), Kp, multiple=WROWS)
    Zx0 = jpk.pack_logical(Zx_np.astype(np.float32), Kp, multiple=WROWS)
    streams = jge.prep_glove_static(c2, x2, n2, V1, Kd, rw, rh, WROWS,
                                    WROWS, 10.0, 0.75)
    m2, f2, l2, winw, sx, rowsx, winx = streams
    dev_order = (c2, x2, m2, f2, l2, sx, rowsx, winx, winw)
    kw = dict(lr=0.05, K=Kd, rw=rw, rh=rh, wrows_w=WROWS, wrows_h=WROWS)
    jopt = JAdaGrad(0.05)
    oc0, ox0 = jopt.init(jnp.asarray(Zc0)), jopt.init(jnp.asarray(Zx0))
    Zc, Zx, oc, ox = packed_state_from_jax(Zc0, Zx0, jax.device_get(oc0),
                                           jax.device_get(ox0), "cpu")
    Zcj, Zxj, ocj, oxj, lj = jge.packed_glove_epoch(
        jnp.asarray(Zc0), jnp.asarray(Zx0), oc0, ox0,
        *(jnp.asarray(a) for a in dev_order),
        jnp.asarray(S * B - 300, jnp.int32), interpret=True, **kw)

    import torch
    _kernels.reset_launches()
    lt = tge.packed_glove_epoch(
        Zc, Zx, oc, ox, *(torch.from_numpy(np.array(a)) for a in dev_order),
        S * B - 300, **kw)
    assert dict(_kernels.launches) == {}           # plain versions on CPU
    tol = dict(rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(Zc.numpy(), np.asarray(Zcj), **tol)
    np.testing.assert_allclose(Zx.numpy(), np.asarray(Zxj), **tol)
    np.testing.assert_allclose(oc["accum"].numpy(),
                               np.asarray(ocj["accum"]), **tol)
    np.testing.assert_allclose(ox["accum"].numpy(),
                               np.asarray(oxj["accum"]), **tol)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    Zc_log = jpk.unpack_array(Zc.numpy(), V1, Kp)
    np.testing.assert_array_equal(Zc_log[:, Kd + 1], 1.0)
    np.testing.assert_array_equal(Zx.numpy()[:V2, Kd], 1.0)
    assert not np.allclose(Zc_log[:, :Kd], Zc_np[:, :Kd])


@pytest.mark.parametrize("Kd,epochs", [(8, 4), (50, 2)])
def test_fit_matches_jax(one_device, Kd, epochs):
    X = _toy_cooc()
    np.random.seed(11)
    mj = cymf_tpu.GloVe(num_components=Kd, batch_size=1024, packed="on")
    mj.fit(X, num_epochs=epochs)
    np.random.seed(11)
    mt = ct.GloVe(num_components=Kd, batch_size=1024, device="cpu")
    mt.fit(X, num_epochs=epochs)
    assert mt.packed_engine_ and len(mt.epoch_times_) == epochs
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-4)
    for name in ("W_central", "W_context", "bias", "context_bias", "W"):
        got, want = getattr(mt, name), getattr(mj, name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                   err_msg=name)
    for col in mt.constant_columns_:
        np.testing.assert_array_equal(col, 1.0)


def test_save_word2vec_format_matches_jax(tmp_path):
    X = _toy_cooc(V=6, seed=3)
    np.random.seed(2)
    mt = ct.GloVe(num_components=3, batch_size=1024, device="cpu")
    mt.fit(X, num_epochs=1)
    mj = cymf_tpu.GloVe(num_components=3)
    mj.W = mt.W
    i2w = {i: f"word{i}" for i in range(6)}
    mt.save_word2vec_format(str(tmp_path / "t.txt"), i2w)
    mj.save_word2vec_format(str(tmp_path / "j.txt"), i2w)
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert text.startswith("6 3\nword0 ")


@pytest.mark.parametrize("kwargs,exc", [
    (dict(update_mode="fast"), ValueError),
    (dict(bias_mode="magic"), ValueError),
    (dict(engine="cuda"), ValueError),
    (dict(packed="maybe"), ValueError),
    (dict(bias_mode="kfold"), NotImplementedError),
    (dict(engine="pallas", bias_mode="kfold"), NotImplementedError),
    (dict(packed="off"), NotImplementedError),
])
def test_invalid_arguments(kwargs, exc):
    with pytest.raises(exc):
        ct.GloVe(**kwargs)


def test_fit_gates():
    X = _toy_cooc(V=10)
    with pytest.raises(ValueError):
        ct.GloVe(device="cpu").fit(None, num_epochs=1)
    with pytest.raises(TypeError):
        ct.GloVe(device="cpu").fit(X.toarray(), num_epochs=1)
    with pytest.raises(ValueError, match="124"):
        ct.GloVe(num_components=125, packed="on", device="cpu").fit(
            X, num_epochs=1)
    with pytest.raises(NotImplementedError, match="in-jit"):
        ct.GloVe(num_components=125, device="cpu").fit(X, num_epochs=1)
    with pytest.raises(NotImplementedError, match="checkpoints"):
        ct.GloVe(device="cpu").fit(X, num_epochs=1, checkpoint_path="g.npz")
