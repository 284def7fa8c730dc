"""Device-prep BPR (``CYMF_TPU_BPR_PREP=device``) against the JAX package.

The port draws each step's negatives from a ``torch.Generator``
(:func:`~cymf_tpu_torch.ops.packed_epoch.draw_negatives`), the JAX package
by threefry; the tests that hold the epochs together replace the port's one
draw function with JAX's draws for the same step, ``randint(fold_in(key,
t))``.  JAX runs on one device, its Pallas kernels in interpret mode at
``precision="highest"``.  Tolerances: ``rtol 2e-4, atol 2e-5`` (float32
sums in another order through an optimizer, as
``tests/test_torch_packed_epoch.py``'s v4 epoch), every element under
every optimizer: over one epoch no Adam first touch flips its sign here,
so the allowance of ``tests/test_torch_batch_engine.py`` is not needed.

The device step is held to the host-prep v4 step bit for bit on the same
draws, and whole fits to host prep's quality, their determinism and
resume.
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
from cymf_tpu.ops.hashset import build_pair_hashset as j_hashset
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.models.bpr import PAD_USER
from cymf_tpu_torch.ops import packed as tpk
from cymf_tpu_torch.ops import packed_epoch as tpe
from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
from cymf_tpu_torch.models.sgd import epoch_generator

# tests/test_bpr.py's device-prep shapes
U, I, K, B, WROWS = 300, 170, 8, 1024, 16
WD = 0.01
TOL = dict(rtol=2e-4, atol=2e-5)
FIT = dict(num_components=10, learning_rate=0.02, batch_size=2048,
           packed="on")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_device():
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


@pytest.fixture(scope="module")
def streams():
    """tests/test_bpr.py's device-prep streams: a 10%-dense 300 x 170
    matrix in user-sorted steps of 1024, the tail padded, the static
    sides prepared once."""
    X = sparse.random(U, I, density=0.1, random_state=4, format="csr")
    X.data[:] = 1.0
    users, items = X.nonzero()
    N = len(users)
    S = -(-N // B)
    pad = S * B - N
    u2 = np.concatenate([users.astype(np.int32),
                         np.full(pad, PAD_USER)]).reshape(S, B)
    i2 = np.concatenate([items.astype(np.int32),
                         np.zeros(pad, np.int32)]).reshape(S, B)
    order = np.argsort(u2, axis=1, kind="stable")
    u2 = np.take_along_axis(u2, order, axis=1)
    i2 = np.take_along_axis(i2, order, axis=1)
    rw = tpk.packed_rows(U, K, multiple=WROWS)
    rh = tpk.logical_rows(I, multiple=WROWS)
    winw, wstart, si, rowsi, wini, bcs, bcn, _ = jpe.prep_static(
        u2, i2, K, rw, rh, WROWS, WROWS)
    rng = np.random.default_rng(4)
    W0 = (rng.normal(size=(U, K)) * 0.1).astype(np.float32)
    H0 = (rng.normal(size=(I, K)) * 0.1).astype(np.float32)
    return dict(X=X, N=N, S=S, u2=u2, i2=i2, rw=rw, rh=rh, winw=winw,
                wstart=wstart, si=si, rowsi=rowsi, wini=wini, bcs=bcs,
                bcn=bcn, Wp=jpk.pack_array(W0, K, multiple=WROWS),
                Hp=jpk.pack_logical(H0, K, multiple=WROWS))


def _t(a):
    return torch.from_numpy(np.array(a))


def _feed(monkeypatch, draws):
    """Replace the port's draw with ``draws`` (numpy arrays), in order."""
    it = iter(draws)

    def draw(gen, B, num_items):
        assert isinstance(gen, torch.Generator)
        return _t(next(it))

    monkeypatch.setattr(tpe, "draw_negatives", draw)


def _jax_draws(key, S):
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, t), (B,),
                                          0, I, dtype=jnp.int32))
            for t in range(S)]


def _port_epoch(st, opt_name, lr):
    """One port device-prep epoch from the initial tables: ``(Wp, Hp, ow,
    oh, loss)``."""
    opt = tpe.make_packed_optimizer(opt_name, lr)
    Wp, Hp = _t(st["Wp"].copy()), _t(st["Hp"].copy())
    ow, oh = opt.init(Wp), opt.init(Hp)
    coo = st["X"].tocoo()
    hs = to_device(build_pair_hashset(coo.row, coo.col), "cpu")
    loss = tpe.packed_bpr_epoch_device(
        Wp, Hp, ow, oh, *(_t(st[k]) for k in ("u2", "i2", "si", "rowsi",
                                              "wini", "winw")),
        hs, torch.Generator(), st["N"],
        opt_name=opt_name, lr=lr, weight_decay=WD, K=K, rw=st["rw"],
        rh=st["rh"], num_users=U, num_items=I, wrows_w=WROWS,
        wrows_h=WROWS)
    return Wp, Hp, ow, oh, loss


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("opt_name,lr", [("adam", 0.02), ("adagrad", 0.05),
                                         ("sgd", 0.05)])
def test_device_epoch_matches_jax(streams, monkeypatch, opt_name, lr):
    st = streams
    key = jax.random.PRNGKey(9)
    jopt = jpe.make_packed_optimizer(opt_name, lr)
    coo = st["X"].tocoo()
    hs = jax.tree_util.tree_map(jnp.asarray, j_hashset(coo.row, coo.col))
    Wj, Hj, owj, ohj, lj = jpe.packed_bpr_epoch_device_j(
        jnp.asarray(st["Wp"]), jnp.asarray(st["Hp"]),
        jopt.init(jnp.asarray(st["Wp"])), jopt.init(jnp.asarray(st["Hp"])),
        *(jnp.asarray(st[k]) for k in ("u2", "i2", "si", "rowsi", "wini",
                                       "winw")),
        hs, key, jnp.asarray(0, jnp.int32), jnp.asarray(st["N"], jnp.int32),
        opt_name=opt_name, lr=lr, weight_decay=WD, K=K, rw=st["rw"],
        rh=st["rh"], num_users=U, num_items=I, wrows_w=WROWS,
        wrows_h=WROWS, interpret=True, precision="highest")

    _feed(monkeypatch, _jax_draws(key, st["S"]))
    Wp, Hp, ow, oh, lt = _port_epoch(st, opt_name, lr)
    _close(tpk.unpack_array(Wp.numpy(), U, K),
           jpk.unpack_array(np.asarray(Wj), U, K), "W")
    _close(Hp.numpy()[:I, :K], np.asarray(Hj)[:I, :K], "H")
    for k in owj:
        _close(ow[k].numpy(), np.asarray(owj[k]), f"ow/{k}")
        _close(oh[k].numpy(), np.asarray(ohj[k]), f"oh/{k}")
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert not np.allclose(Wp.numpy(), st["Wp"])
    assert not np.allclose(Hp.numpy(), st["Hp"])


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_device_epoch_equals_host_v4_bit_for_bit(streams, monkeypatch,
                                                 opt_name):
    """The device epoch and host prep's v4 epoch (``packed_bpr_epoch``),
    fed the same negatives, run the same step body on the same inputs:
    the host side's mask by a search over the sorted positive keys, its
    j side by a stable argsort and the host window builder."""
    st = streams
    rng = np.random.default_rng(11)
    j2 = rng.integers(0, I, (st["S"], B)).astype(np.int32)
    coo = st["X"].tocoo()
    pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    mask = tpe._reject_mask(st["u2"], j2, pos_keys, U, I)
    assert 0 < mask.sum() < mask.size - 100          # collisions, padding
    sj, rowsj, winj = tpe._sorted_side(j2, st["rh"], WROWS, tpe.TILE)

    opt = tpe.make_packed_optimizer(opt_name, 0.02)
    Wh, Hh = _t(st["Wp"].copy()), _t(st["Hp"].copy())
    owh, ohh = opt.init(Wh), opt.init(Hh)
    lh = tpe.packed_bpr_epoch(
        Wh, Hh, owh, ohh,
        *(_t(a) for a in (st["u2"], st["i2"], st["si"], st["rowsi"],
                          st["wini"], j2, mask, sj, rowsj, winj,
                          st["winw"], st["wstart"], st["bcs"], st["bcn"])),
        st["N"], opt_name=opt_name, lr=0.02, weight_decay=WD, K=K,
        rw=st["rw"], rh=st["rh"], wrows_w=WROWS, wrows_h=WROWS, kernel_v=4)

    _feed(monkeypatch, list(j2))
    Wd, Hd, owd, ohd, ld = _port_epoch(st, opt_name, 0.02)
    assert float(ld) == float(lh)
    np.testing.assert_array_equal(Wd.numpy(), Wh.numpy())
    np.testing.assert_array_equal(Hd.numpy(), Hh.numpy())
    for k in owh:
        np.testing.assert_array_equal(owd[k].numpy(), owh[k].numpy())
        np.testing.assert_array_equal(ohd[k].numpy(), ohh[k].numpy())


def test_draws_uniform_and_deterministic():
    gen = epoch_generator(1234, 3, "cpu")
    draws = torch.cat([tpe.draw_negatives(gen, 4096, 50) for _ in range(50)])
    assert draws.dtype == torch.int32 and draws.device.type == "cpu"
    assert int(draws.min()) == 0 and int(draws.max()) == 49
    counts = np.bincount(draws.numpy(), minlength=50)
    expect = draws.numel() / 50
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 100.0, chi2               # 49 degrees of freedom
    again = epoch_generator(1234, 3, "cpu")
    torch.testing.assert_close(tpe.draw_negatives(again, 4096, 50),
                               draws[:4096], rtol=0, atol=0)
    other = epoch_generator(1234, 4, "cpu")
    assert not torch.equal(tpe.draw_negatives(other, 4096, 50),
                           draws[:4096])


def test_mask_is_hashset_membership(streams):
    st = streams
    coo = st["X"].tocoo()
    hs = to_device(build_pair_hashset(coo.row, coo.col), "cpu")
    truth = set(zip(coo.row.tolist(), coo.col.tolist()))
    rng = np.random.default_rng(2)
    u = np.concatenate([st["u2"].ravel(), coo.row.astype(np.int32)])
    j = np.concatenate([rng.integers(0, I, st["u2"].size),
                        coo.col]).astype(np.int32)
    got = tpe.live_negatives(hs, _t(u), _t(j), U).numpy()
    want = np.array([a < U and (a, b) not in truth
                     for a, b in zip(u.tolist(), j.tolist())])
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() > coo.nnz                  # positives and padding


def _fit(monkeypatch, prep, epochs=8, seed=3, **ck):
    monkeypatch.setenv("CYMF_TPU_BPR_PREP", prep)
    d = SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                 density=0.08, seed=11)
    m = ct.BPR(device="cpu", **FIT)
    m.fit(d.train, num_epochs=epochs, verbose=False, seed=seed, **ck)
    return m, d


def test_device_prep_fit_quality(monkeypatch):
    """tests/test_bpr.py's gate: device prep reaches 0.8x host prep's
    test DCG@5 on the same data (another, equally uniform stream)."""
    m_host, d = _fit(monkeypatch, "host")
    m_dev, _ = _fit(monkeypatch, "device")
    assert m_dev.prep_backend_ == "device-torch"
    assert m_dev.packed_kernel_ == 4 and m_dev.engine_ == "packed"
    assert m_host.packed_kernel_ == 5
    assert all(set(e) == {"device_s"} for e in m_dev.epoch_times_)
    ev = ct.AoaEvaluator(d.test, d.train, metrics=["DCG"], k=5,
                         device="cpu")
    dcg_host = ev.evaluate(m_host.W, m_host.H)["DCG@5"]
    dcg_dev = ev.evaluate(m_dev.W, m_dev.H)["DCG@5"]
    assert dcg_dev > 0.8 * dcg_host, (dcg_dev, dcg_host)
    assert np.isfinite(m_dev.last_loss)


def test_device_prep_fit_deterministic(monkeypatch):
    a, _ = _fit(monkeypatch, "device", epochs=3)
    b, _ = _fit(monkeypatch, "device", epochs=3)
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)
    c, _ = _fit(monkeypatch, "device", epochs=3, seed=4)
    assert not np.array_equal(a.W, c.W)


def test_device_prep_resume_equals_uninterrupted(monkeypatch, tmp_path):
    p = str(tmp_path / "bpr.npz")
    m1, _ = _fit(monkeypatch, "device", epochs=6)
    m2, _ = _fit(monkeypatch, "device", epochs=3, checkpoint_path=p)
    m3, _ = _fit(monkeypatch, "device", epochs=6, checkpoint_path=p,
                 resume=True)
    assert len(m2.checkpoint_s_) == 3 and len(m3.epoch_times_) == 3
    assert m3.prep_backend_ == "device-torch"
    np.testing.assert_array_equal(m3.W, m1.W)
    np.testing.assert_array_equal(m3.H, m1.H)
    assert m3.last_loss == m1.last_loss


ERRORS = {"sometimes": "must be host|device", "": "must be host|device",
          "device": "conflicts with neg_pool"}


@pytest.mark.parametrize("value", list(ERRORS))
def test_bpr_prep_errors_match_jax(monkeypatch, one_device, value):
    monkeypatch.setenv("CYMF_TPU_BPR_PREP", value)
    kw = dict(FIT, neg_pool=128 if value == "device" else 0)
    X = SyntheticImplicitDataset(num_user=60, num_item=40, rank=3,
                                 density=0.2, seed=1).train
    with pytest.raises(ValueError, match=ERRORS[value]):
        ct.BPR(device="cpu", **kw).fit(X, num_epochs=1, verbose=False)
    with pytest.raises(ValueError, match=ERRORS[value]):
        cymf_tpu.BPR(**kw).fit(X, num_epochs=1, verbose=False)


@pytest.mark.parametrize("kw", [dict(packed="off"), dict(num_components=128),
                                dict(engine="pallas", packed="auto")])
def test_bpr_prep_read_by_packed_engine_only(monkeypatch, kw):
    """The wide, batch and sequential engines ignore the variable, as in
    the JAX package."""
    monkeypatch.setenv("CYMF_TPU_BPR_PREP", "sometimes")
    X = SyntheticImplicitDataset(num_user=60, num_item=40, rank=3,
                                 density=0.2, seed=1).train
    m = ct.BPR(device="cpu", **dict(FIT, **kw))
    m.fit(X, num_epochs=1, verbose=False)
    assert np.isfinite(m.W).all()
