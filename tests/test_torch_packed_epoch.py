"""The port's packed epochs and their host prep against the JAX package's.

The JAX side runs the numpy prep stream (``CYMF_TPU_PREP=numpy``) and its
Pallas kernels in interpret mode.  Host streams, the pipeline choice
(``engine_version``) and the full ``prep_static`` must be bit-equal.  One
v4 epoch on identical streams (JAX pinned to v4,
``CYMF_TPU_PACKED_KERNEL=4``, at ``precision="highest"``) must agree to
the ``rtol 2e-4, atol 2e-5`` of ``tests/test_packed_accum.py`` (float32
sums in another order, through an optimizer); the v5, v6 and v7 epochs,
whose JAX kernels expand and accumulate through a bf16 hi+lo split, to
that file's "split" tolerance ``rtol 8e-4, atol 8e-5``; the pool epoch
(v8) to ``tests/test_packed_pool.py``'s: ``rtol 2e-4, atol 2e-5`` under
sgd, ``rtol 2e-2, atol 1e-3`` under adam (its rsqrt amplifies the split's
rounding at near-zero second moments).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import packed as jpk
from cymf_tpu.ops import packed_epoch as jpe
from cymf_tpu_torch.convert import packed_state_from_jax
from cymf_tpu_torch.ops import packed as tpk
from cymf_tpu_torch.ops import packed_epoch as tpe

U, I, B, S, WROWS = 12000, 200, 1024, 2, 256
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
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")


@pytest.fixture
def _jax_v4(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", "4")


def _streams(K, seed=3):
    """Sparse user-sorted steps with a padded tail, as the trainer builds
    them (1024 samples over 12,000 users keep the JAX engine on v4)."""
    rng = np.random.default_rng(seed)
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    u2[-1, -100:] = np.int32(2**31 - 1)          # PAD_USER tail
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    i2[-1, -100:] = 0
    rw = tpk.packed_rows(U, K, multiple=WROWS)
    rh = tpk.logical_rows(I, multiple=WROWS)
    live = u2 < U
    pos_keys = np.sort(u2[live].astype(np.int64) * I + i2[live])
    return u2, i2, rw, rh, pos_keys


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("K", [20, 31, 64])
def test_prep_bit_equal(K, _jax_v4):
    u2, i2, rw, rh, pos_keys = _streams(K)
    want = jpe.prep_static(u2, i2, K, rw, rh, WROWS, WROWS)
    assert want[-1] == 4
    _assert_equal(tpe.prep_static(u2, i2, K, rw, rh, WROWS, WROWS), want)
    got = tpe.prep_epoch(np.random.default_rng((1234, 1)), u2, i2, pos_keys,
                         U, I, K, rh, WROWS)
    want = jpe.prep_epoch(np.random.default_rng((1234, 1)), u2, i2,
                          pos_keys, U, I, K, rh, WROWS)
    assert got[1].sum() < got[1].size - 100       # some samples masked
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _tables(K, seed=5):
    rng = np.random.default_rng(seed)
    W0 = rng.normal(size=(U, K)).astype(np.float32) * 0.1
    H0 = rng.normal(size=(I, K)).astype(np.float32) * 0.1
    return (jpk.pack_array(W0, K, multiple=WROWS),
            jpk.pack_logical(H0, K, multiple=WROWS))


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("K", [20, 31])
def test_epoch_matches_jax(K, opt, _jax_v4):
    u2, i2, rw, rh, pos_keys = _streams(K)
    winw, wstart, si, rowsi, wini, bcs, bcn, v = jpe.prep_static(
        u2, i2, K, rw, rh, WROWS, WROWS)
    j2, mask, sj, rowsj, winj = jpe.prep_epoch(
        np.random.default_rng(9), u2, i2, pos_keys, U, I, K, rh, WROWS)
    Wp0, Hp0 = _tables(K)
    jopt = jpe.make_packed_optimizer(opt, LR)
    n_valid = int((u2 < U).sum())
    kw = dict(opt_name=opt, lr=LR, weight_decay=WD, K=K, rw=rw, rh=rh,
              wrows_w=WROWS, wrows_h=WROWS)
    Wj, Hj, owj, ohj, lj = jpe.packed_bpr_epoch(
        jnp.asarray(Wp0), jnp.asarray(Hp0), jopt.init(jnp.asarray(Wp0)),
        jopt.init(jnp.asarray(Hp0)),
        *(jnp.asarray(a) for a in (u2, i2, si, rowsi, wini, j2, mask, sj,
                                   rowsj, winj, winw, wstart, bcs, bcn)),
        jnp.asarray(n_valid, jnp.int32), interpret=True,
        precision="highest", kernel_v=v, **kw)

    topt = tpe.make_packed_optimizer(opt, LR)
    Wp, Hp = torch.from_numpy(Wp0.copy()), torch.from_numpy(Hp0.copy())
    ow, oh = topt.init(Wp), topt.init(Hp)
    lt = tpe.packed_bpr_epoch(
        Wp, Hp, ow, oh,
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (u2, i2, si, rowsi, wini, j2, mask, sj, rowsj, winj, winw, wstart,
           bcs, bcn)),
        n_valid, kernel_v=v, **kw)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), **tol)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hj), **tol)
    for k in owj:
        np.testing.assert_allclose(ow[k].numpy(), np.asarray(owj[k]), **tol)
        np.testing.assert_allclose(oh[k].numpy(), np.asarray(ohj[k]), **tol)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # the update really moved both tables, masked rows included
    assert not np.allclose(Wp.numpy(), Wp0)
    assert not np.allclose(Hp.numpy(), Hp0)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_packed_state_from_jax_roundtrip(opt):
    Wp0, Hp0 = _tables(20)
    jopt = jpe.make_packed_optimizer(opt, LR)
    ow = {k: np.asarray(v) + 0.5 for k, v in
          jopt.init(jnp.asarray(Wp0)).items()}
    oh = {k: np.asarray(v) - 0.25 for k, v in
          jopt.init(jnp.asarray(Hp0)).items()}
    Wp, Hp, tow, toh = packed_state_from_jax(Wp0, Hp0, ow, oh, "cpu")
    assert Wp.dtype == torch.float32 and Wp.device.type == "cpu"
    np.testing.assert_array_equal(Wp.numpy(), Wp0)
    np.testing.assert_array_equal(Hp.numpy(), Hp0)
    assert set(tow) == set(ow) and set(toh) == set(oh)
    for k in ow:
        np.testing.assert_array_equal(tow[k].numpy(), ow[k])
        np.testing.assert_array_equal(toh[k].numpy(), oh[k])
    # the port's state is its own copy: updating it leaves the source
    Wp += 1.0
    assert not np.array_equal(Wp.numpy(), Wp0)
    np.testing.assert_array_equal(
        tpk.unpack_array(Wp0, U, 20), jpk.unpack_array(Wp0, U, 20))


def _gated_streams(U, K, wrows, seed=3):
    """``tests/test_packed_accum.py``'s streams (I = 200, two steps of
    1024 user-sorted samples) with a padding tail on the last step."""
    rng = np.random.default_rng(seed)
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    u2[-1, -100:] = np.int32(2**31 - 1)
    i2[-1, -100:] = 0
    live = u2 < U
    pos_keys = np.sort(u2[live].astype(np.int64) * I + i2[live])
    return (u2, i2, tpk.packed_rows(U, K, multiple=wrows),
            tpk.logical_rows(I, multiple=wrows), pos_keys)


# the pipeline gate's cases of tests/test_packed_accum.py: a table smaller
# than the v5 window, a dense stream (v6), a sparse one (v4), v7 forced,
# and K = 31 (s (K + 1) = 128, no free loss lane)
GATE_CASES = [(300, 20, 128, 5, ""), (1200, 20, 512, 6, ""),
              (12000, 20, 512, 4, ""), (12000, 20, 512, 7, "7"),
              (12000, 31, 512, 4, "7"), (1200, 20, 512, 5, "5"),
              (300, 20, 128, 4, "4")]


@pytest.mark.parametrize("U,K,wrows,want_v,force", GATE_CASES)
def test_engine_version_and_prep_static_bit_equal(U, K, wrows, want_v, force,
                                                  monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", force)
    u2, i2, rw, rh, _ = _gated_streams(U, K, wrows)
    for stream in (u2, None):
        assert tpe.engine_version(K, rw, wrows, u2=stream) == \
            jpe.engine_version(K, rw, wrows, u2=stream)
    want = jpe.prep_static(u2, i2, K, rw, rh, wrows, wrows)
    assert want[-1] == want_v
    _assert_equal(tpe.prep_static(u2, i2, K, rw, rh, wrows, wrows), want)


def test_v6_switch_bit_equal(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_V6", "off")
    u2, *_ = _gated_streams(1200, 20, 512)
    rw = tpk.packed_rows(1200, 20, multiple=512)
    assert tpe.engine_version(20, rw, 512, u2=u2) == \
        jpe.engine_version(20, rw, 512, u2=u2) == 5


@pytest.mark.parametrize("P,r2", [(128, False), (256, True)])
def test_pool_prep_bit_equal(P, r2):
    K = 20
    u2, i2, rw, rh, pos_keys = _gated_streams(500, K, 512)
    _assert_equal(tpe.prep_static_pool(u2, i2, K, rw, rh, 512, 512),
                  jpe.prep_static_pool(u2, i2, K, rw, rh, 512, 512))
    fixed = np.random.default_rng(1).integers(0, P, u2.shape,
                                              dtype=np.int32) if r2 else None
    got = tpe.prep_pool_epoch(np.random.default_rng((7, 2)), u2, pos_keys,
                              500, I, P, r2=fixed)
    want = jpe.prep_pool_epoch(np.random.default_rng((7, 2)), u2, pos_keys,
                               500, I, P, r2=fixed)
    assert got[2].min() == 0 and got[2].max() == 1    # some rejected
    _assert_equal(got, want)


def _jax_epoch(fn, Wp0, Hp0, opt, arrays, n_valid, **kw):
    jopt = jpe.make_packed_optimizer(opt, LR)
    Wj, Hj, owj, ohj, lj = fn(
        jnp.asarray(Wp0), jnp.asarray(Hp0), jopt.init(jnp.asarray(Wp0)),
        jopt.init(jnp.asarray(Hp0)), *(jnp.asarray(a) for a in arrays),
        jnp.asarray(n_valid, jnp.int32), interpret=True, **kw)
    return Wj, Hj, owj, ohj, lj


def _torch_epoch(fn, Wp0, Hp0, opt, arrays, n_valid, **kw):
    topt = tpe.make_packed_optimizer(opt, LR)
    Wp, Hp = torch.from_numpy(Wp0.copy()), torch.from_numpy(Hp0.copy())
    ow, oh = topt.init(Wp), topt.init(Hp)
    lt = fn(Wp, Hp, ow, oh,
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
            n_valid, **kw)
    return Wp, Hp, ow, oh, lt


def _close_states(got, want, rtol, atol):
    Wp, Hp, ow, oh, lt = got
    Wj, Hj, owj, ohj, lj = want
    np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hj), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("U,K,wrows,want_v,force", GATE_CASES[:4])
def test_gated_epochs_match_jax(U, K, wrows, want_v, force, opt,
                                monkeypatch):
    """v5, v6, v7 (and v4 on the sparse stream) through one epoch each."""
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", force)
    u2, i2, rw, rh, pos_keys = _gated_streams(U, K, wrows)
    winw, wstart, si, rowsi, wini, bcs, bcn, v = tpe.prep_static(
        u2, i2, K, rw, rh, wrows, wrows)
    assert v == want_v
    j2, mask, sj, rowsj, winj = tpe.prep_epoch(
        np.random.default_rng(9), u2, i2, pos_keys, U, I, K, rh, wrows)
    Wp0, Hp0 = (tpk.pack_array(np.random.default_rng(5).normal(
        size=(U, K)).astype(np.float32) * 0.1, K, multiple=wrows),
        tpk.pack_logical(np.random.default_rng(6).normal(
            size=(I, K)).astype(np.float32) * 0.1, K, multiple=wrows))
    arrays = (u2, i2, si, rowsi, wini, j2, mask, sj, rowsj, winj, winw,
              wstart, bcs, bcn)
    kw = dict(opt_name=opt, lr=LR, weight_decay=WD, K=K, rw=rw, rh=rh,
              wrows_w=wrows, wrows_h=wrows, kernel_v=v)
    n_valid = int((u2 < U).sum())
    want = _jax_epoch(jpe.packed_bpr_epoch, Wp0, Hp0, opt, arrays, n_valid,
                      **kw)
    got = _torch_epoch(tpe.packed_bpr_epoch, Wp0, Hp0, opt, arrays, n_valid,
                       **kw)
    _close_states(got, want, 8e-4, 8e-5)
    assert not np.allclose(got[0].numpy(), Wp0)


@pytest.mark.parametrize("opt,P", [("sgd", 128), ("adam", 256)])
def test_pool_epoch_matches_jax(opt, P):
    U, K, wrows = 500, 20, 512
    u2, i2, rw, rh, pos_keys = _gated_streams(U, K, wrows)
    winw, si, rowsi, wini = tpe.prep_static_pool(u2, i2, K, rw, rh, wrows,
                                                 wrows)
    pool2, rjs, mask, _ = tpe.prep_pool_epoch(np.random.default_rng(7), u2,
                                              pos_keys, U, I, P)
    Wp0 = tpk.pack_array(np.random.default_rng(5).normal(
        size=(U, K)).astype(np.float32) / K, K, multiple=wrows)
    Hp0 = tpk.pack_logical(np.random.default_rng(6).normal(
        size=(I, K)).astype(np.float32) / K, K, multiple=wrows)
    arrays = (u2, i2, si, rowsi, wini, pool2, rjs, mask, winw)
    kw = dict(opt_name=opt, lr=LR, weight_decay=WD, K=K, rw=rw, rh=rh,
              wrows_w=wrows, wrows_h=wrows)
    n_valid = int((u2 < U).sum())
    want = _jax_epoch(jpe.packed_bpr_pool_epoch, Wp0, Hp0, opt, arrays,
                      n_valid, **kw)
    got = _torch_epoch(tpe.packed_bpr_pool_epoch, Wp0, Hp0, opt, arrays,
                       n_valid, **kw)
    rtol, atol = (2e-2, 1e-3) if opt == "adam" else (2e-4, 2e-5)
    _close_states(got, want, rtol, atol)
    assert not np.allclose(got[1].numpy(), Hp0)
