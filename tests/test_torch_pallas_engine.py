"""The port's sequential engine (``engine="pallas"``) against ``cymf_tpu``'s.

Inputs are made with numpy from a seed and go through both packages; the
JAX kernels run in interpret mode, the port's epochs on their plain
versions (CPU tensors).  Whole fits pin the JAX side to a 1-device mesh,
the path the port copies.  Tolerances:

- streams (negatives, masks) and fused-table conversions: bit-equal;
- tables after an epoch or a fit: ``rtol 2e-4, atol 2e-5`` (float32 sums
  in another order along a dependent chain); under adam fewer than 1% of
  elements outside that and none off by more than ``2.5 lr`` (the drift
  class of a first touch whose tiny gradient flips sign);
- the loss: relative ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.ops import pallas_engine as jpe
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import pallas_state_from_jax, pallas_state_to_jax
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import pallas_engine as tpe

OPTIMIZERS = ["sgd", "adagrad", "adam"]
# (catalog rows, group): a 3-row catalog makes rows collide inside a group
CASES = [(None, 1), (None, 8), (3, 8)]


@pytest.fixture
def one_device():
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


def _close(got, want, optimizer, lr, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want)
    bad = err > 2e-5 + 2e-4 * np.abs(want)
    if optimizer != "adam":
        assert not bad.any(), (what, err.max())
        return
    assert bad.sum() < 0.01 * got.size, (what, int(bad.sum()))
    assert err.max() <= 2.5 * lr, (what, err.max())


def _jax_tables(Wo, Ho, K, optimizer):
    return [pallas_state_from_jax(np.asarray(T), K, optimizer, "cpu")
            for T in (Wo, Ho)]


def _streams(*arrays, S, chunk):
    sh = (S, 1, chunk)
    return ([jnp.asarray(a.reshape(sh)) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a.reshape(sh)))
             for a in arrays])


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("items,group", CASES)
def test_bpr_epoch_matches_jax(optimizer, items, group):
    """The setup of tests/test_pallas_engine.py's BPR test."""
    rng = np.random.default_rng(0)
    U, I, K, N, chunk = 24, items or 16, 8, 96, 32
    S = N // chunk
    W0 = rng.normal(size=(U, K)).astype(np.float32) * 0.1
    H0 = rng.normal(size=(I, K)).astype(np.float32) * 0.1
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    j = rng.integers(0, I, N).astype(np.int32)
    mask = ((rng.random(N) > 0.1) & (i != j)).astype(np.int32)
    kw = dict(optimizer=optimizer, lr=0.05, wd=0.01, group=group)
    js, ts = _streams(u, i, j, mask, S=S, chunk=chunk)
    Wo, Ho, loss = jpe.bpr_pallas_epoch(jpe.pack_table(W0, optimizer),
                                        jpe.pack_table(H0, optimizer), *js,
                                        interpret=True, **kw)
    _kernels.reset_launches()
    W, H, tloss = tpe.bpr_pallas_epoch(tpe.pack_table(W0, optimizer, "cpu"),
                                       tpe.pack_table(H0, optimizer, "cpu"),
                                       *ts, **kw)
    assert not _kernels.launches             # the CPU runs the plain version
    for got, want in zip((W, H), _jax_tables(Wo, Ho, K, optimizer)):
        _close(got, want, optimizer, 0.05)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("items,group", CASES)
def test_relmf_epoch_matches_jax(optimizer, items, group):
    rng = np.random.default_rng(1)
    U, I, K, N, chunk = 20, items or 14, 6, 96, 32
    S = N // chunk
    W0 = rng.normal(size=(U, K)).astype(np.float32) * 0.1
    H0 = rng.normal(size=(I, K)).astype(np.float32) * 0.1
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    w = ((rng.random(N) < 0.3) * rng.uniform(1, 5, N)).astype(np.float32)
    mask = (rng.random(N) > 0.1).astype(np.int32)
    kw = dict(optimizer=optimizer, lr=0.05, wd=0.01, group=group)
    js, ts = _streams(u, i, w, mask, S=S, chunk=chunk)
    Wo, Ho, loss = jpe.relmf_pallas_epoch(jpe.pack_table(W0, optimizer),
                                          jpe.pack_table(H0, optimizer), *js,
                                          interpret=True, **kw)
    W, H, tloss = tpe.relmf_pallas_epoch(
        tpe.pack_table(W0, optimizer, "cpu"),
        tpe.pack_table(H0, optimizer, "cpu"), *ts, **kw)
    for got, want in zip((W, H), _jax_tables(Wo, Ho, K, optimizer)):
        _close(got, want, optimizer, 0.05)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("words,group", CASES)
def test_glove_epoch_matches_jax(words, group):
    rng = np.random.default_rng(2)
    V1, V2, K, N, chunk = words or 14, words or 12, 6, 64, 32
    S = N // chunk
    aug = [np.concatenate(p, axis=1).astype(np.float32) for p in (
        [rng.normal(size=(V1, K)) * 0.1, rng.normal(size=(V1, 1)) * 0.1,
         np.ones((V1, 1))],
        [rng.normal(size=(V2, K)) * 0.1, np.ones((V2, 1)),
         rng.normal(size=(V2, 1)) * 0.1])]
    c = rng.integers(0, V1, N).astype(np.int32)
    x = rng.integers(0, V2, N).astype(np.int32)
    cnt = (rng.exponential(3, N) + 1).astype(np.float32)
    mask = (rng.random(N) > 0.1).astype(np.int32)
    f = np.minimum((cnt / 10.0) ** 0.75, 1.0).astype(np.float32)
    logcnt = np.log(cnt).astype(np.float32)
    js, ts = _streams(c, x, f, logcnt, mask, S=S, chunk=chunk)
    Wo, Xo, loss = jpe.glove_pallas_epoch(
        *(jpe.pack_table(a, "adagrad") for a in aug), *js, lr=0.05,
        k_dim=K, interpret=True, group=group)
    A, B, tloss = tpe.glove_pallas_epoch(
        *(tpe.pack_table(a, "adagrad", "cpu") for a in aug), *ts, lr=0.05,
        k_dim=K, group=group)
    for got, want in zip((A, B), _jax_tables(Wo, Xo, K + 2, "adagrad")):
        _close(got, want, "adagrad", 0.05)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    assert (A[:, K + 1] == 1).all() and (B[:, K] == 1).all()


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("K", [5, 8, 52])
def test_pallas_state_conversion_both_ways(optimizer, K):
    """JAX fused table -> the port's equals the port's own packing, and
    back equals the JAX package's packing, lane for lane."""
    T = np.random.default_rng(K).normal(size=(13, K)).astype(np.float32)
    J = np.asarray(jpe.pack_table(T, optimizer))
    P = tpe.pack_table(T, optimizer, "cpu")
    got = pallas_state_from_jax(J, K, optimizer, "cpu")
    segments = {"sgd": 1, "adagrad": 2, "adam": 3}[optimizer]
    assert got.shape == (13, tpe.segment_width(K) * segments)
    assert torch.equal(got, P)
    np.testing.assert_array_equal(pallas_state_to_jax(P, K, optimizer), J)
    np.testing.assert_array_equal(np.asarray(tpe.unpack_table(P, K)), T)
    with pytest.raises(ValueError):
        pallas_state_from_jax(J[:, :100], K, optimizer, "cpu")


@pytest.mark.parametrize("rows,optimizer", [
    (943 + 1682, "adam"), (138493 + 26744, "adam"), (10240, "adagrad"),
    (10241, "adagrad"), (20480, "sgd"), (20481, "sgd"), (6826, "adam"),
    (6827, "adam")])
def test_fits_vmem_gate_matches_jax(rows, optimizer):
    assert tpe.fits_vmem(rows, optimizer) == jpe.fits_vmem(rows, optimizer)


def test_generate_epoch_negatives_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    users = rng.integers(0, 50, 5000).astype(np.int32)
    items = rng.integers(0, 30, 5000).astype(np.int32)
    keys = np.sort(users.astype(np.int64) * 30 + items)
    for pos_keys in (keys, keys[:0]):
        jj, jk = jpe.generate_epoch_negatives(np.random.default_rng(7), users,
                                              30, pos_keys)
        tj, tk = tpe.generate_epoch_negatives(np.random.default_rng(7), users,
                                              30, pos_keys)
        np.testing.assert_array_equal(tj, jj)
        np.testing.assert_array_equal(tk, jk)
        assert tj.dtype == np.int32 and tk.dtype == bool
        assert tk.all() == (len(pos_keys) == 0)


def _tiny():
    return SyntheticImplicitDataset(num_user=20, num_item=15, rank=3,
                                    density=0.2, seed=2)


@pytest.mark.parametrize("epochs,validate", [(3, False), (2, True),
                                             (1, False)])
def test_bpr_fit_matches_jax(one_device, epochs, validate):
    """Without a validator and with more than one epoch the fit is one
    launch; otherwise one a epoch.  ``last_loss`` is the mean over the
    launch's samples either way, as in JAX."""
    d = _tiny()
    fits = []
    for pkg, kw in ((cymf_tpu, {}), (ct, dict(device="cpu"))):
        ev = pkg.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                              **kw) if validate else None
        np.random.seed(0)
        m = pkg.BPR(num_components=4, learning_rate=0.05, engine="pallas",
                    **kw)
        m.fit(d.train, num_epochs=epochs, valid_evaluator=ev, verbose=False,
              seed=3)
        fits.append(m)
    mj, mt = fits
    _close(mt.W, mj.W, "adam", 0.05, "W")
    _close(mt.H, mj.H, "adam", 0.05, "H")
    assert mt.last_loss == pytest.approx(mj.last_loss, rel=1e-5)
    assert len(mt.epoch_times_) == (1 if epochs > 1 and not validate
                                    else epochs)
    assert sum(e["epochs"] for e in mt.epoch_times_) == epochs


@pytest.mark.parametrize("binary", [True, False])
def test_relmf_fit_matches_jax(one_device, binary):
    """Labels come from X's values: a non-binary X trains too."""
    d = _tiny()
    X = sparse.csr_matrix(d.train)
    if not binary:
        X.data = np.random.default_rng(0).integers(1, 5, X.nnz).astype(float)
    fits = []
    for pkg, kw in ((cymf_tpu, {}), (ct, dict(device="cpu"))):
        np.random.seed(0)
        m = pkg.RelMF(num_components=4, learning_rate=0.05, engine="pallas",
                      **kw)
        m.fit(X, num_epochs=2, verbose=False, seed=3)
        fits.append(m)
    mj, mt = fits
    _close(mt.W, mj.W, "adam", 0.05, "W")
    _close(mt.H, mj.H, "adam", 0.05, "H")
    assert mt.last_loss == pytest.approx(mj.last_loss, rel=1e-5)


def test_glove_fit_matches_jax(one_device):
    """The tests/test_pallas_engine.py fit; ``last_loss`` is the epoch's
    loss sum in both packages."""
    rng = np.random.default_rng(5)
    dense = np.triu(rng.integers(0, 15, (12, 12))
                    * (rng.random((12, 12)) < 0.4))
    X = sparse.csr_matrix(dense.astype(np.float64))
    fits = []
    for pkg, kw in ((cymf_tpu, {}), (ct, dict(device="cpu"))):
        np.random.seed(4)
        m = pkg.GloVe(num_components=4, learning_rate=0.05, batch_size=32,
                      engine="pallas", **kw)
        m.fit(X, num_epochs=2)
        fits.append(m)
    mj, mt = fits
    for name in ("W", "bias", "context_bias", "W_central", "W_context"):
        _close(getattr(mt, name), getattr(mj, name), "adagrad", 0.05, name)
    assert mt.last_loss == pytest.approx(mj.last_loss, rel=1e-5)
    assert mt.last_loss > 1.0               # a sum over the epoch, not a mean
    for col in mt.constant_columns_:
        np.testing.assert_array_equal(col, 1.0)


def test_pallas_fits_learn_on_quickstart_data():
    """The README quickstart with the sequential engine: test DCG@5 well
    above an untrained model's, early stopping restoring the best epoch."""
    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                            device="cpu")
    test = ct.AoaEvaluator(d.test, d.train, k=5, device="cpu")
    kw = dict(num_components=20, learning_rate=0.01, weight_decay=0.01,
              engine="pallas", device="cpu")
    m0 = ct.BPR(**kw)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.BPR(**kw)
    m.fit(d.train, num_epochs=4, valid_evaluator=valid, early_stopping=True,
          verbose=False)
    assert test.evaluate(m.W, m.H)["DCG@5"] >= base + 0.1


def test_pallas_gates():
    rng = np.random.default_rng(6)
    X = sparse.coo_matrix((np.ones(100), (rng.integers(0, 60000, 100),
                                          rng.integers(0, 60000, 100))),
                          shape=(60000, 60000)).tocsr()
    with pytest.raises(ValueError, match="budget"):
        ct.GloVe(num_components=4, engine="pallas", device="cpu").fit(
            X, num_epochs=1)
    with pytest.raises(ValueError, match="budget"):
        ct.GloVe(num_components=125, engine="pallas", device="cpu").fit(
            X[:100, :100], num_epochs=1)
    with pytest.raises(ValueError, match="K <= 128"):
        ct.BPR(num_components=129, engine="pallas", device="cpu").fit(
            X[:100, :100], num_epochs=1, verbose=False)
    W = tpe.pack_table(np.zeros((4, 8)), "sgd", "cpu")
    idx = torch.zeros((2, 1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide"):
        tpe.bpr_pallas_epoch(W, W.clone(), idx, idx, idx, idx,
                             optimizer="sgd", lr=0.1, wd=0.0, group=8)
    with pytest.raises(ValueError, match="layout"):
        tpe.bpr_pallas_epoch(W, tpe.pack_table(np.zeros((4, 12)), "sgd",
                                               "cpu"), idx, idx, idx, idx,
                             optimizer="sgd", lr=0.1, wd=0.0, group=4)


@pytest.mark.parametrize("rows_a,rows_b,optimizer,K,want", [
    (943, 1682, "adam", 20, 0),      # chip_smoke's ml-100k BPR and RelMF
    (5000, 5000, "adagrad", 52, 0),  # its 5,000-word GloVe (d=50 + 2)
    (600, 300, "adam", 20, 1),       # the pallas quickstart
    (6826, 0, "adam", 128, 0),       # fits_vmem's edge: 6826 rows fit ...
    (20480, 0, "sgd", 128, 0),       # ... and 20480 under sgd
    (0, 0, "adam", 20, 1)])
def test_seq_placement_at_the_main_shapes(rows_a, rows_b, optimizer, K,
                                          want):
    """The plan mirror keeps the tables in the block's shared memory only
    where both fused tables fit beside the staging ring; every catalog
    the JAX gate admits at 128 lanes goes to device memory."""
    n = {"sgd": 0, "adagrad": 1, "adam": 2}[optimizer]
    row_bytes = (1 + n) * tpe.segment_width(K) * 4
    assert tpe.seq_placement(rows_a, rows_b, row_bytes) == want
    if rows_a in (6826, 20480):
        assert tpe.fits_vmem(rows_a, optimizer)
        assert not tpe.fits_vmem(rows_a + 1, optimizer)


@pytest.mark.parametrize("row_bytes", [16, 80, 240, 416, 1536])
@pytest.mark.parametrize("ratio", [1, 3])
def test_seq_placement_block_edge(row_bytes, ratio):
    """One row under the block's capacity stays in shared memory, one row
    over goes to device memory; the ring leaves the tables
    ``SMEM_MAX_BYTES - RING_BYTES``."""
    assert tpe.TABLE_BYTES == tpe.SMEM_MAX_BYTES - tpe.RING_BYTES == 219_648
    rows = tpe.TABLE_BYTES // row_bytes
    a = rows * ratio // (ratio + 1)
    assert tpe.seq_placement(a, rows - a, row_bytes) == 1
    assert tpe.seq_placement(a + 1, rows - a, row_bytes) == 0
    assert tpe.seq_placement(a, rows - a + 1, row_bytes) == 0


@pytest.mark.parametrize("placement", [0, 1])
def test_forced_placement_on_cpu_raises(placement):
    """``_placement`` applies to the kernel: on CPU tables (the plain
    version) it raises instead of being ignored."""
    W = tpe.pack_table(np.zeros((4, 8)), "sgd", "cpu")
    idx = torch.zeros((1, 1, 8), dtype=torch.int32)
    val = torch.zeros((1, 1, 8), dtype=torch.float32)
    kw = dict(optimizer="sgd", lr=0.1, wd=0.0, _placement=placement)
    with pytest.raises(ValueError, match="_placement"):
        tpe.bpr_pallas_epoch(W, W.clone(), idx, idx, idx, idx, **kw)
    with pytest.raises(ValueError, match="_placement"):
        tpe.relmf_pallas_epoch(W, W.clone(), idx, idx, val, idx, **kw)
    G = tpe.pack_table(np.ones((4, 8)), "adagrad", "cpu")
    with pytest.raises(ValueError, match="_placement"):
        tpe.glove_pallas_epoch(G, G.clone(), idx, idx, val, val, idx,
                               lr=0.1, k_dim=6, _placement=placement)
    # without it the same calls run the plain version
    tpe.bpr_pallas_epoch(W, W.clone(), idx, idx, idx, idx,
                         optimizer="sgd", lr=0.1, wd=0.0)
