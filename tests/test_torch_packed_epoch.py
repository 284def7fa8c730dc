"""The port's packed v4 epoch and its host prep against the JAX package's.

The JAX side is pinned to the path the port copies: the v4 pipeline
(``CYMF_TPU_PACKED_KERNEL=4``) with the numpy prep stream
(``CYMF_TPU_PREP=numpy``), its Pallas kernels in interpret mode at
``precision="highest"``.  Host streams must be bit-equal; one epoch on
identical streams must agree to the ``rtol 2e-4, atol 2e-5`` of
``tests/test_packed_accum.py`` (float32 sums in another order, through
an optimizer).
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
def _jax_v4_numpy(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", "4")
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")


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


@pytest.mark.parametrize("K", [20, 31, 64])
def test_prep_bit_equal(K):
    u2, i2, rw, rh, pos_keys = _streams(K)
    jw, _, jsi, jrowsi, jwini, _, _, v = jpe.prep_static(
        u2, i2, K, rw, rh, WROWS, WROWS)
    assert v == 4
    for got, want in zip(tpe.prep_static(u2, i2, K, rw, rh, WROWS, WROWS),
                         (jw, jsi, jrowsi, jwini)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
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
def test_epoch_matches_jax(K, opt):
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
          (u2, i2, si, rowsi, wini, j2, mask, sj, rowsj, winj, winw)),
        n_valid, **kw)
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
