"""The plain versions of the v5-v8 BPR kernels against the JAX package's
Pallas kernels (interpret mode), on the same seeded numpy inputs.

The JAX kernels expand and accumulate rows through one-hot matmuls with a
bf16 hi+lo split of the float32 values, exact to about 2^-16 relative
(`tests/test_packed_pool.py`); the port reads and sums float32 rows.  So
the outputs agree to ``rtol 1e-4, atol 1e-5`` and the loss sums to
relative ``1e-4``.  The streams are user-sorted steps as the trainer
builds them: a padding tail of sentinel users, masked samples, chunks
that straddle a window or block, ``K = 20`` and ``K = 41`` (``s (K + 1) =
126``), and for v5/v6 a sparse stream that the span gate refuses, whose
rows outside a window must expand to zeros in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import fused_sample as jfs
from cymf_tpu.ops import fused_step as jst
from cymf_tpu.ops import packed as jpk
from cymf_tpu.ops import packed_epoch as jpe
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import fused_sample as tfs
from cymf_tpu_torch.ops import fused_step as tst
# the streams and inputs the card tests run the v8 kernel on
from test_torch_cuda_kernels import (BLOCK_STREAMS, POOL_STREAMS, _block_case,
                                     _block_stream, _pool_case, _range_case,
                                     pool_streams)

TOL = dict(rtol=1e-4, atol=1e-5)
WD, I, PAD = 0.013, 300, np.int32(2**31 - 1)


def _step(U, K, B, wrows, pad=100, seed=0):
    """Tables and one user-sorted step: ``(Wp, Hp, u, i, j, mf, rw)``."""
    rng = np.random.default_rng(seed + U + K)
    rw = jpk.packed_rows(U, K, multiple=wrows)
    Wp = jpk.pack_array(rng.normal(size=(U, K)) * 0.3, K, multiple=wrows)
    Hp = jpk.pack_logical(rng.normal(size=(I, K)) * 0.3, K, multiple=wrows)
    u = np.sort(rng.integers(0, U, B)).astype(np.int32)
    u[B - pad:] = PAD
    i = rng.integers(0, I, B).astype(np.int32)
    j = rng.integers(0, I, B).astype(np.int32)
    mf = ((rng.random(B) > 0.1) & (u < U)).astype(np.float32)
    return Wp, Hp, u, i, j, mf, rw


def _decorated(Hp, rows, u, mf, K):
    s = jpk.num_slots(K)
    return np.array(jfs.decorate(jnp.asarray(Hp[rows]),
                                 jnp.asarray(u % s), jnp.asarray(mf), K))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("U,K,dense", [(290, 20, True), (300, 41, True),
                                       (12000, 20, False)])
def test_sample_phase_v5_plain_matches_jax(U, K, dense):
    B = 1024
    Wp, Hp, u, i, j, mf, rw = _step(U, K, B, 8)
    s = jpk.num_slots(K)
    phys = np.minimum(u // s, 2**31 - 1).astype(np.int32)
    win = min(jfs.WROWS_A, rw)
    wstart = np.clip(phys[::jfs.TILE], 0, max(rw - win, 0)).astype(np.int32)
    out = (phys < wstart.repeat(jfs.TILE)) \
        | (phys >= wstart.repeat(jfs.TILE) + win)
    live_out = (out & (phys < rw)).any()
    assert live_out != dense        # the refused stream has rows outside
    Dj = _decorated(Hp, j, u, mf, K)
    SWj, Qj, lj = jfs.bpr_sample_phase_v5(
        jnp.asarray(Wp), jnp.asarray(wstart),
        jnp.asarray(phys.reshape(-1, 128)), jnp.asarray(Hp[i]),
        jnp.asarray(Dj), K=K, wd=WD, interpret=True)
    _kernels.reset_launches()
    SW, Q, loss = tfs.bpr_sample_phase_v5(*_t(Wp, wstart, phys, Hp[i], Dj),
                                          K=K, wd=WD)
    assert not _kernels.launches
    _close(SW, SWj)
    _close(Q, Qj)
    np.testing.assert_allclose(float(loss), float(lj[0, 0]), rtol=1e-4)
    # a row outside its window expands to zeros: wu = 0, so Q's payload is 0
    rows_out = out & (phys < rw) & (mf > 0)
    assert (Q.numpy()[rows_out, :K] == 0).all()


def test_sample_phase_v5_rejects_what_jax_rejects():
    x = torch.zeros(512, 128)
    rows = torch.zeros(512, dtype=torch.int32)
    st = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        tfs.bpr_sample_phase_v5(x, st, rows, x, x, K=64, wd=WD)
    with pytest.raises(ValueError, match="multiple of tile"):
        tfs.bpr_sample_phase_v5(x, st, rows[:500], x[:500], x[:500], K=20,
                                wd=WD)


@pytest.mark.parametrize("U,dense", [(4000, True), (12000, False)])
def test_block_step_v6_plain_matches_jax(U, dense):
    K, B, wrows = 20, 4096 if dense else 2048, 512
    Wp, Hp, u, i, j, mf, rw = _step(U, K, B, wrows)
    s = jpk.num_slots(K)
    phys = np.minimum(u // s, 2**31 - 1).astype(np.int32)
    wstart = np.clip(phys[::tst.TILE], 0, rw - tst.CROWS).astype(np.int32)
    cs, cn = tst.prep_blocks(wstart, rw, wrows)
    np.testing.assert_array_equal(
        np.stack([cs, cn]), np.stack(jst.prep_blocks(wstart, rw, wrows)))
    ch = phys.reshape(-1, tst.TILE)
    live = np.where(ch < rw, ch, -1)
    # a chunk whose rows run from one block into the next
    assert ((ch[:, 0] // wrows) != (live.max(axis=1) // wrows)).any()
    assert jpe._spans_fit(phys[None].astype(np.int64), tst.TILE, tst.CROWS,
                          rw) == dense
    Dj = _decorated(Hp, j, u, mf, K)
    Awj, Qj = jst.bpr_block_step_v6(
        jnp.asarray(Wp), jnp.asarray(phys.reshape(-1, 128)),
        jnp.asarray(Hp[i]), jnp.asarray(Dj), jnp.asarray(wstart),
        jnp.asarray(cs), jnp.asarray(cn), K=K, wd=WD, rw=rw, wrows=wrows,
        interpret=True)
    _kernels.reset_launches()
    Aw, Q = tst.bpr_block_step_v6(*_t(Wp, phys, Hp[i], Dj, wstart, cs, cn),
                                  K=K, wd=WD, rw=rw, wrows=wrows)
    assert not _kernels.launches
    _close(Aw, Awj)
    _close(Q, Qj)
    assert Aw[:, tst.LOSS_LANE].abs().sum() > 0      # the loss lane


def _range_step(U, K, B, wrows, monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", "7")
    Wp, Hp, u, i, j, mf, rw = _step(U, K, B, wrows)
    s = jpk.num_slots(K)
    winw, *_, v = jpe.prep_static(u[None], i[None], K, rw,
                                  jpk.logical_rows(I, wrows), wrows, wrows)
    assert v == 7
    phys = np.minimum(u // s, 2**31 - 1).astype(np.int32)
    # a window's range holds chunks with rows of another window
    st, cnt = winw[0]
    assert (st % tst.TILE != 0).any() or (cnt % tst.TILE != 0).any()
    Du = _decorated(Wp, np.minimum(phys, rw - 1), u, mf, K)
    return Wp, Hp, u, i, j, mf, rw, phys, Du, winw[0]


@pytest.mark.parametrize("U,K,wrows", [(12000, 20, 512), (3000, 41, 256)])
def test_range_step_v7_plain_matches_jax(U, K, wrows, monkeypatch):
    B = 2048
    Wp, Hp, u, i, j, mf, rw, phys, Du, win = _range_step(U, K, B, wrows,
                                                         monkeypatch)
    Awj, Qj = jst.bpr_range_step_v7(
        jnp.asarray(phys.reshape(-1, 128)), jnp.asarray(Du),
        jnp.asarray(Hp[i]), jnp.asarray(Hp[j]), jnp.asarray(win[0]),
        jnp.asarray(win[1]), K=K, wd=WD, rw=rw, wrows=wrows, interpret=True)
    _kernels.reset_launches()
    Aw, Q = tst.bpr_range_step_v7(*_t(phys, Du, Hp[i], Hp[j], win[0],
                                      win[1]), K=K, wd=WD, rw=rw,
                                  wrows=wrows)
    assert not _kernels.launches
    _close(Aw, Awj)
    _close(Q, Qj)


@pytest.mark.parametrize("P,K", [(128, 20), (256, 41)])
def test_pool_step_v8_plain_matches_jax(P, K, monkeypatch):
    B, U, wrows = 2048, 12000, 512
    Wp, Hp, u, i, j, mf, rw, phys, Du, win = _range_step(U, K, B, wrows,
                                                         monkeypatch)
    rng = np.random.default_rng(P)
    pool = rng.integers(0, I, P).astype(np.int32)
    rj = rng.integers(0, P, B).astype(np.int32)
    Awj, Apj, Qj = jst.bpr_pool_step_v8(
        jnp.asarray(phys.reshape(-1, 128)), jnp.asarray(rj.reshape(-1, 128)),
        jnp.asarray(Du), jnp.asarray(Hp[i]), jnp.asarray(Hp[pool]),
        jnp.asarray(win[0]), jnp.asarray(win[1]), K=K, wd=WD, rw=rw,
        wrows=wrows, interpret=True)
    _kernels.reset_launches()
    Aw, Ap, Q = tst.bpr_pool_step_v8(*_t(phys, rj, Du, Hp[i], Hp[pool],
                                         win[0], win[1]), K=K, wd=WD, rw=rw,
                                     wrows=wrows)
    assert not _kernels.launches
    _close(Aw, Awj)
    _close(Ap, Apj)
    _close(Q, Qj)
    # every live sample counted once in the pool's count lane
    assert float(Ap[:, K].sum()) == float(mf.sum())


@pytest.mark.parametrize("K", [10, 20, 24, 25, 31, 41, 62, 100])
@pytest.mark.parametrize("rw,wrows", [(256, 256), (264, 264), (512, 512),
                                      (1024, 512), (1024, 256), (768, 512)])
def test_gates_match_jax(K, rw, wrows):
    assert tst.supports_v6(K, rw, wrows) == jst.supports_v6(K, rw, wrows)
    assert tst.supports_v7(K, rw, wrows) == jst.supports_v7(K, rw, wrows)
    for P in (0, 100, 128, 1024, 2048, 2176):
        assert tst.supports_v8(K, rw, wrows, P) == \
            jst.supports_v8(K, rw, wrows, P)


@pytest.mark.parametrize("rw,wrows", [(1024, 512), (2048, 512), (264, 264)])
def test_prep_blocks_bit_equal(rw, wrows):
    rng = np.random.default_rng(rw)
    wstart = np.sort(rng.integers(0, rw - 200, 37)).astype(np.int32)
    for got, want in zip(tst.prep_blocks(wstart, rw, wrows),
                         jst.prep_blocks(wstart, rw, wrows)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _pool_twin(stream, drop, P, part, zero_gap):
    args, kw = _pool_case(torch.device("cpu"), pool_streams()[stream], P,
                          drop)
    rows, rj, *_, st, ct = args
    t = tst.fused_step_twin(8, rows.numpy(), rjs=rj.numpy(),
                            starts=st.numpy(), counts=ct.numpy(), P=P,
                            rw=kw["rw"], wrows=kw["wrows"], part=part,
                            zero_gap=zero_gap)
    return args, kw, t


@pytest.mark.parametrize("zero_gap", [0, 32])
@pytest.mark.parametrize("part", [64, 100])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("stream", POOL_STREAMS)
def test_pool_step_twin_owns_each_sample_once(stream, drop, part, zero_gap):
    """The v8 kernel's partition on the card tests' adversarial streams
    (one user with 40% of the samples, runs cut at every part boundary, a
    padding tail; slots outside the pool; window ranges that drop
    samples): its keep rule is the plain version's, each kept sample is
    summed once into its own row and no other sample anywhere, each Aw row
    is written once (zeros included), each Q row once, and each kept
    sample whose slot is in the pool adds into Apool once."""
    P = 128
    args, kw, t = _pool_twin(stream, drop, P, part, zero_gap)
    rows, rj, *_, st, ct = args
    keep = tst._window_keep(rows.long(), st, ct, rw=kw["rw"],
                            wrows=kw["wrows"], tile=tst.TILE,
                            B=rows.numel()).numpy()
    np.testing.assert_array_equal(t["keep"], keep)
    assert 0 < keep.sum() < keep.size or (drop and stream == "padding-tail")
    np.testing.assert_array_equal(t["carried"], keep)
    np.testing.assert_array_equal(t["into"][keep], rows.numpy()[keep])
    np.testing.assert_array_equal(t["writes"], np.ones(kw["rw"]))
    np.testing.assert_array_equal(t["q_writes"], np.ones(rows.numel()))
    rj = rj.numpy()
    home = keep & (rj >= 0) & (rj < P)
    assert (rj >= P).any() and (rj < 0).any()
    np.testing.assert_array_equal(t["pool_from"], home)
    np.testing.assert_array_equal(t["pool_adds"],
                                  np.bincount(rj[home], minlength=P))
    if stream == "part-cuts":     # runs joined, one over 513 samples
        assert t["joined"] >= 15 and t["walk"] >= 513 // part - 1


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("stream", POOL_STREAMS)
def test_pool_step_twin_sums_match_plain_and_jax(stream, drop):
    """The sums the twin's partition gives (SW of each sample into the row
    the twin stores it in, Q into Apool where the twin adds it) against
    the plain version and the JAX kernel in interpret mode; Q against the
    JAX kernel's on the samples it writes (those inside a window's
    tile-extended range)."""
    P = 128
    args, kw, t = _pool_twin(stream, drop, P, 64, 32)
    rows, rj, Du, Hi, Hpool, st, ct = args
    K = kw["K"]
    inpool = (rj >= 0) & (rj < P)
    hj = torch.where(inpool[:, None], Hpool[rj.long().clamp(0, P - 1)], 0.0)
    SW, Q = tst._fused_math(Du, Hi, hj, K, kw["wd"])
    sel = torch.from_numpy(t["carried"] > 0)
    Aw = torch.zeros((kw["rw"], tst.LANES))
    Aw.index_add_(0, torch.from_numpy(t["into"])[sel], SW[sel])
    frm = torch.from_numpy(t["pool_from"] > 0)
    Ap = torch.zeros((P, tst.LANES))
    Ap.index_add_(0, rj.long()[frm], Q[frm])
    _kernels.reset_launches()
    Awp, App, Qp = tst.bpr_pool_step_v8(*args, **kw)
    assert not _kernels.launches
    for got, want in ((Aw, Awp), (Ap, App), (Q, Qp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    Awj, Apj, Qj = jst.bpr_pool_step_v8(
        jnp.asarray(rows.numpy().reshape(-1, 128)),
        jnp.asarray(rj.numpy().reshape(-1, 128)), jnp.asarray(Du.numpy()),
        jnp.asarray(Hi.numpy()), jnp.asarray(Hpool.numpy()),
        jnp.asarray(st.numpy()), jnp.asarray(ct.numpy()), K=K, wd=kw["wd"],
        rw=kw["rw"], wrows=kw["wrows"], interpret=True)
    _close(Aw, Awj)
    _close(Ap, Apj)
    b = np.arange(rows.numel())
    s0, c0 = np.maximum(st.numpy(), 0), np.maximum(ct.numpy(), 0)
    covered = ((b[:, None] >= s0) & (b[:, None] < s0 + -(-c0 // tst.TILE)
                                     * tst.TILE)).any(axis=1)
    _close(Q[covered], np.array(Qj)[covered])


CPU = torch.device("cpu")
STEP_STREAMS = [(6, s) for s in POOL_STREAMS + BLOCK_STREAMS] + [
    (7, s) for s in POOL_STREAMS]


def _step_twin(version, stream, drop, part, zero_gap):
    """The v6 or v7 inputs on the CPU, the kernel's twin, and the plain
    version's ``(homed, keep)``."""
    if version == 6:
        args, kw = _block_case(CPU, *_block_stream(stream)[:1], drop,
                               _block_stream(stream)[1])
        rows, cs, cn = args[1], args[5], args[6]
        t = tst.fused_step_twin(6, rows.numpy(), cs=cs.numpy(),
                                cn=cn.numpy(), rw=kw["rw"],
                                wrows=kw["wrows"], part=part,
                                zero_gap=zero_gap)
        homed, keep = tst._block_keep(rows.long(), cs, cn, rw=kw["rw"],
                                      wrows=kw["wrows"], tile=tst.TILE,
                                      B=rows.numel())
        return args, kw, t, rows, homed.numpy(), keep.numpy()
    args, kw = _range_case(CPU, pool_streams()[stream], drop)
    rows, *_, st, ct = args
    t = tst.fused_step_twin(7, rows.numpy(), starts=st.numpy(),
                            counts=ct.numpy(), rw=kw["rw"], wrows=kw["wrows"],
                            part=part, zero_gap=zero_gap)
    keep = tst._window_keep(rows.long(), st, ct, rw=kw["rw"],
                            wrows=kw["wrows"], tile=tst.TILE, B=rows.numel())
    return args, kw, t, rows, np.ones(rows.numel(), bool), keep.numpy()


@pytest.mark.parametrize("zero_gap", [0, 32])
@pytest.mark.parametrize("part", [64, 128])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("version,stream", STEP_STREAMS)
def test_fused_step_twin_owns_each_sample_once(version, stream, drop, part,
                                               zero_gap):
    """The v6 and v7 kernels' partition on the adversarial streams (v8's,
    and for v6 a chunk's spill into the next block, rows past the spill,
    the last block's spill), with ranges that drop samples (v7) or leave
    chunks without a home block (v6): its keep rule is the plain
    version's, each kept sample is summed once into its own row and no
    other sample anywhere, each Aw row is written once (zeros included),
    each Q row once, as zeros exactly where the chunk has no home."""
    args, kw, t, rows, homed, keep = _step_twin(version, stream, drop, part,
                                                zero_gap)
    np.testing.assert_array_equal(t["keep"], keep)
    assert 0 < keep.sum() < keep.size or (
        drop and version == 7 and stream == "padding-tail")
    np.testing.assert_array_equal(t["carried"], keep)
    np.testing.assert_array_equal(t["into"][keep], rows.numpy()[keep])
    np.testing.assert_array_equal(t["writes"], np.ones(kw["rw"]))
    np.testing.assert_array_equal(t["q_writes"], np.ones(rows.numel()))
    np.testing.assert_array_equal(t["q_zero"], ~homed)
    assert (~homed).any() == (drop and version == 6)
    assert "pool_from" not in t


def _jax_step(version, args, kw):
    """The JAX kernel of ``version`` in interpret mode on ``args``."""
    K, wd, rw, wrows = kw["K"], kw["wd"], kw["rw"], kw["wrows"]
    if version == 6:
        Wp, rows, Hi, Dj, ws, cs, cn = (jnp.asarray(a.numpy()) for a in args)
        return jst.bpr_block_step_v6(Wp, rows.reshape(-1, 128), Hi, Dj, ws,
                                     cs, cn, K=K, wd=wd, rw=rw, wrows=wrows,
                                     interpret=True)
    rows, Du, Hi, Dj, st, ct = (jnp.asarray(a.numpy()) for a in args)
    return jst.bpr_range_step_v7(rows.reshape(-1, 128), Du, Hi, Dj, st, ct,
                                 K=K, wd=wd, rw=rw, wrows=wrows,
                                 interpret=True)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("version,stream", STEP_STREAMS)
def test_fused_step_twin_sums_match_plain_and_jax(version, stream, drop):
    """The sums the v6/v7 twin's partition gives (SW of each sample into
    the row the twin stores it in; Q, zeros where the twin writes zeros)
    against the plain version and the JAX kernel in interpret mode; Q
    against the JAX kernel's on the samples it writes (v6: those of a
    chunk with a home block; v7: those inside a window's tile-extended
    range)."""
    args, kw, t, rows, homed, _ = _step_twin(version, stream, drop, 64, 32)
    K = kw["K"]
    if version == 6:
        Wp, _, Hi, Dj, ws, *_ = args
        Du, hj = tfs.expand_rows(Wp, rows.long(),
                                 ws.long().repeat_interleave(tst.TILE),
                                 tst.CROWS, Dj, K)
        SW, Q = tst._fused_math(Du, Hi, hj, K, kw["wd"])
        plain = tst.bpr_block_step_v6
    else:
        _, Du, Hi, Dj, st, ct = args
        SW, Q = tst._fused_math(Du, Hi, Dj, K, kw["wd"])
        plain = tst.bpr_range_step_v7
    Q = torch.where(torch.from_numpy(t["q_zero"])[:, None], 0.0, Q)
    sel = torch.from_numpy(t["carried"] > 0)
    Aw = torch.zeros((kw["rw"], tst.LANES))
    Aw.index_add_(0, torch.from_numpy(t["into"])[sel], SW[sel])
    _kernels.reset_launches()
    Awp, Qp = plain(*args, **kw)
    assert not _kernels.launches
    for got, want in ((Aw, Awp), (Q, Qp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    Awj, Qj = _jax_step(version, args, kw)
    if version == 6:
        # the JAX v6 kernel also expands the W rows through its bf16 hi+lo
        # one-hot matmul, so each sample's SW carries that 2^-16 relative
        # error; part-cuts sums runs of up to 513 samples into one row
        # (payload sums up to ~7, errors up to ~1.7e-5): atol 1e-5 scaled
        # by the largest payload sum, at least 1
        cb = tst.pk.count_base(K)
        scale = max(1.0, float(np.abs(np.array(Awj)[:, :cb]).max()))
        np.testing.assert_allclose(Aw.numpy(), np.array(Awj), rtol=1e-4,
                                   atol=1e-5 * scale)
        covered = homed
    else:
        _close(Aw, Awj)
        b = np.arange(rows.numel())
        s0, c0 = np.maximum(st.numpy(), 0), np.maximum(ct.numpy(), 0)
        covered = ((b[:, None] >= s0) & (b[:, None] < s0 + -(-c0 // tst.TILE)
                                         * tst.TILE)).any(axis=1)
    _close(Q[covered], np.array(Qj)[covered])


@pytest.mark.parametrize("stream", BLOCK_STREAMS)
def test_block_step_v6_spill_rules(stream):
    """v6's keep rule on the streams built for it, in the twin and the
    plain version alike: a chunk homed in block 0 keeps its rows in block
    1's first 264 (the spill), drops rows past that, and the samples on
    rows past the table (the last block's spill) are dropped."""
    args, kw, t, rows, homed, keep = _step_twin(6, stream, False, 64, 32)
    r = rows.numpy()
    chunk1 = np.arange(r.size) // tst.TILE == 1
    assert homed.all() and (t["keep"] == keep).all()
    spill = chunk1 & (r >= kw["wrows"]) & (r < kw["wrows"] + tst.CROWS)
    past = chunk1 & (r >= kw["wrows"] + tst.CROWS)
    beyond = (r >= kw["rw"]) & (r < kw["rw"] + tst.CROWS)
    want = {"spill": (spill, past), "past-spill": (spill, past),
            "last-spill": (None, beyond)}[stream]
    if want[0] is not None:
        assert want[0].any() and keep[want[0]].all()
    assert (want[1].any() and not keep[want[1]].any()) == (
        stream != "spill")
    assert not keep[r >= kw["rw"]].any()


def test_block_step_v6_homeless_chunk_q_is_zero():
    """Hand-made block ranges that leave chunks without a home block: the
    plain version writes zeros to those Q rows and sums none of their
    samples, as the twin says the kernel does, and its Aw matches the JAX
    kernel's, which never visits those chunks."""
    args, kw, t, rows, homed, keep = _step_twin(6, "spill", True, 64, 32)
    assert (~homed).sum() >= 2 * tst.TILE
    Aw, Q = tst.bpr_block_step_v6(*args, **kw)
    Wp, _, Hi, Dj, ws, *_ = args
    Du, hj = tfs.expand_rows(Wp, rows.long(),
                             ws.long().repeat_interleave(tst.TILE),
                             tst.CROWS, Dj, kw["K"])
    _, Qall = tst._fused_math(Du, Hi, hj, kw["K"], kw["wd"])
    assert (Q.numpy()[~homed] == 0).all()
    assert (Qall.numpy()[~homed] != 0).any()
    np.testing.assert_array_equal(Q.numpy()[homed], Qall.numpy()[homed])
    np.testing.assert_array_equal(t["q_zero"], ~homed)
    assert not keep[~homed].any()
    Awj, _ = _jax_step(6, args, kw)
    _close(Aw, Awj)
