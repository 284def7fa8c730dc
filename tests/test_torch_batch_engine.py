"""The port's portable batch engines (``packed="off"``) against the JAX
package's, and held to the sequential reference replicas.

The JAX side runs on one device (``conftest.py`` fakes 8).  BPR and RelMF
draw their negatives or cells inside the step: the port from a
``torch.Generator``, the JAX package by threefry, so the tests that hold
the two together replace the port's one draw function
(``models.bpr._draw_negatives``, ``models.relmf._draw_cells``) with the
JAX package's draws for the same epoch and step.  GloVe draws nothing.

Tolerances, tables and losses of one or two epochs and of whole fits:
sgd and adagrad ``rtol 1e-5, atol 1e-6`` (float32 sums in another order:
XLA's fused row reductions add in an order of their own).  Adam at least
99% of elements within ``rtol 1e-4, atol 1e-5`` and every element within
``3 lr`` (a first touch whose tiny gradient takes the other sign moves a
row by about ``lr``: the drift class of ``tests/test_torch_bpr.py``).
Adam's per-element step ``m / sqrt(v)`` turns a gradient's rounding
difference into a step difference of the same relative size, so elements
whose gradients cancel drift further than under sgd: after two BPR epochs
at lr 0.01, 98.8% of H's elements are within the sgd tolerance and the
worst element is off by 1.2e-5 (0.0012 lr).

The convergence gates use the replicas of ``tests/test_reference_parity.py``
with its data, hyperparameters and margins; the port's draws are its own,
so they check statistics, not streams.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.models import bpr as jbpr
from cymf_tpu.models import glove as jglove
from cymf_tpu.models import relmf as jrelmf
from cymf_tpu.ops.hashset import build_pair_hashset as j_hashset
from cymf_tpu.optim import make_optimizer as j_make_optimizer
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.convert import batch_state_from_jax
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.models import bpr as tbpr
from cymf_tpu_torch.models import glove as tglove
from cymf_tpu_torch.models import relmf as trelmf
from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
from cymf_tpu_torch.optim import make_optimizer

PAD = 2**31 - 1
TOL = dict(rtol=1e-5, atol=1e-6)


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
def data():
    return SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                    density=0.08, seed=11)


def _close(got, want, optimizer, lr, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if optimizer != "adam":
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        return
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert ok.mean() >= 0.99, (what, ok.mean())
    assert np.abs(got - want).max() <= 3 * lr, what


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _feed(monkeypatch, module, name, draws):
    """Replace ``module.name`` with a function handing out ``draws`` (numpy
    arrays or tuples of them) in order, one a call."""
    it = iter(draws)

    def draw(gen, B, *args):
        d = next(it)
        return tuple(_t(a) for a in d) if isinstance(d, tuple) else _t(d)

    monkeypatch.setattr(module, name, draw)


def _bpr_draws(seed, epochs, S, B, I):
    """The JAX batch engine's negatives: step ``s`` of epoch ``e`` draws
    from ``fold_in(fold_in(PRNGKey(seed), e), s)``."""
    out = []
    for e in range(epochs):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            out.append(np.asarray(jax.random.randint(
                jax.random.fold_in(key, s), (B,), 0, I, dtype=jnp.int32)))
    return out


def _relmf_draws(seed, epochs, S, B, U, I):
    """The JAX batch engine's cells: a split of the step key into the
    user and the item draw."""
    out = []
    for e in range(epochs):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            ku, ki = jax.random.split(jax.random.fold_in(key, s))
            out.append(tuple(np.asarray(jax.random.randint(
                k, (B,), 0, n, dtype=jnp.int32)) for k, n in ((ku, U),
                                                              (ki, I))))
    return out


def _bpr_streams(X, B, seed=0):
    """Shuffled interactions in user-sorted ``[S, B]`` steps, the tail
    padded with ``PAD``."""
    users, items = X.nonzero()
    order = np.random.default_rng(seed).permutation(len(users))
    return tbpr.sorted_batches(users[order].astype(np.int32),
                               items[order].astype(np.int32), B, multiple=1)


def _init(shape, seed):
    return (np.random.default_rng(seed).uniform(-0.1, 0.1, shape)
            / shape[1]).astype(np.float32)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.05), ("adagrad", 0.05),
                                          ("adam", 0.01)])
def test_bpr_epoch_matches_jax(data, one_device, monkeypatch, optimizer, lr,
                               mode):
    """One and two epochs of ``_bpr_epoch`` from the same state on the
    same streams and negatives (the last step padded)."""
    X = sparse.csr_matrix(data.train)
    U, I = X.shape
    u2, i2 = _bpr_streams(X, 256)
    S, B = u2.shape
    assert (u2 == PAD).any()
    W0, H0 = _init((U, 12), 1), _init((I, 12), 2)
    coo = X.tocoo()
    jopt = j_make_optimizer(optimizer, lr)
    jfn = jax.jit(functools.partial(
        jbpr._bpr_epoch, optimizer=jopt, weight_decay=0.01, num_users=U,
        num_items=I, update_mode=mode, u_presorted=True))
    jst = [jnp.asarray(W0), jnp.asarray(H0)]
    jst += [jopt.init(jst[0]), jopt.init(jst[1])]
    hs_j = j_hashset(coo.row, coo.col)
    opt = make_optimizer(optimizer, lr)
    W, H = _t(W0.copy()), _t(H0.copy())
    ow, oh = opt.init(W), opt.init(H)
    hs = to_device(build_pair_hashset(coo.row, coo.col), "cpu")
    _feed(monkeypatch, tbpr, "_draw_negatives", _bpr_draws(5, 2, S, B, I))
    for e in range(2):
        *jst, jloss = jfn(*jst, jnp.asarray(u2), jnp.asarray(i2), hs_j,
                          jnp.asarray(X.nnz, jnp.int32),
                          jax.random.fold_in(jax.random.PRNGKey(5), e))
        loss = tbpr._bpr_epoch(W, H, ow, oh, _t(u2), _t(i2), hs, X.nnz,
                               None, optimizer=opt, weight_decay=0.01,
                               num_users=U, num_items=I, update_mode=mode)
        _close(W, jst[0], optimizer, lr, f"W, epoch {e}")
        _close(H, jst[1], optimizer, lr, f"H, epoch {e}")
        for side, (got, want) in enumerate(((ow, jst[2]), (oh, jst[3]))):
            for k in want:
                _close(got[k], want[k], optimizer, lr, f"{k} {side}")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def _label_src(X, binary, pkg):
    if binary:
        coo = X.tocoo()
        if pkg == "jax":
            return j_hashset(coo.row, coo.col)
        return to_device(build_pair_hashset(coo.row, coo.col), "cpu")
    arrays = (X.indptr.astype(np.int32), X.indices.astype(np.int32),
              X.data.astype(np.float32))
    if pkg == "jax":
        return tuple(jnp.asarray(a) for a in arrays)
    return tuple(_t(a) for a in arrays)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("binary", [True, False])
def test_relmf_epoch_matches_jax(data, one_device, monkeypatch, binary,
                                 mode):
    """One and two epochs of ``_relmf_epoch`` (Adam) from the same state
    on the same cells, binary labels from the hash set and non-binary
    ones from ``csr_lookup``."""
    X = sparse.csr_matrix(data.train).astype(np.float64)
    if not binary:
        X.data[:] = np.random.default_rng(4).integers(1, 5, X.nnz)
    U, I = X.shape
    B, S, lr = 1024, 4, 0.01
    props = np.maximum(np.asarray(X.mean(axis=0)).ravel()
                       / np.asarray(X.mean(axis=0)).max(), 1e-5) ** 0.5
    W0, H0 = _init((U, 8), 3), _init((I, 8), 4)
    jopt = j_make_optimizer("adam", lr)
    kw = dict(weight_decay=0.01, clip_value=0.1, num_users=U, num_items=I,
              num_steps=S, batch_size=B, update_mode=mode,
              binary_labels=binary)
    jfn = jax.jit(functools.partial(jrelmf._relmf_epoch, optimizer=jopt,
                                    **kw))
    jst = [jnp.asarray(W0), jnp.asarray(H0)]
    jst += [jopt.init(jst[0]), jopt.init(jst[1])]
    opt = make_optimizer("adam", lr)
    W, H = _t(W0.copy()), _t(H0.copy())
    ow, oh = opt.init(W), opt.init(H)
    _feed(monkeypatch, trelmf, "_draw_cells", _relmf_draws(9, 2, S, B, U, I))
    src_j, src_t = _label_src(X, binary, "jax"), _label_src(X, binary, "t")
    for e in range(2):
        *jst, jloss = jfn(*jst, src_j, jnp.asarray(props[:, None],
                                                   jnp.float32),
                          jax.random.fold_in(jax.random.PRNGKey(9), e),
                          jnp.asarray(0, jnp.int32))
        loss = trelmf._relmf_epoch(W, H, ow, oh, src_t,
                                   _t(props[:, None], torch.float32), None,
                                   optimizer=opt, **kw)
        _close(W, jst[0], "adam", lr, f"W, epoch {e}")
        _close(H, jst[1], "adam", lr, f"H, epoch {e}")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def _glove_inputs(V1=90, V2=70, K=8, S=3, B=512, seed=0):
    """Steps sorted by central id, the last 200 triples padding."""
    rng = np.random.default_rng(seed)
    c2 = rng.integers(0, V1, (S, B)).astype(np.int32)
    c2[-1, -200:] = PAD
    c2 = np.sort(c2, axis=1)
    x2 = rng.integers(0, V2, (S, B)).astype(np.int32)
    n2 = rng.integers(1, 40, (S, B)).astype(np.float32)
    n2[c2 == PAD] = 1.0
    tables = [rng.uniform(-0.5, 0.5, shape) / K
              for shape in ((V1, K), (V1,), (V2, K), (V2,))]
    return c2, x2, n2, tables, int((c2 != PAD).sum())


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("bias_mode", ["fused", "kfold"])
def test_glove_epoch_matches_jax(one_device, bias_mode, mode):
    """Two epochs of ``_glove_epoch`` from the same state on the same
    streams; fused mode's constant columns stay exactly one."""
    from cymf_tpu_torch.ops.glove_epoch import augment_tables
    K, lr = 8, 0.05
    c2, x2, n2, (Wc0, bc0, Wx0, bx0), N = _glove_inputs(K=K)
    V1 = Wc0.shape[0]
    if bias_mode == "fused":
        Wc0, Wx0 = augment_tables(Wc0, bc0, Wx0, bx0)
        bc0 = bx0 = np.zeros(1)
    st0 = [np.asarray(a, np.float32).reshape(len(a), -1)
           for a in (Wc0, Wx0, bc0, bx0)]
    jopt = cymf_tpu.optim.AdaGrad(lr)
    kw = dict(x_max=10.0, alpha=0.75, learning_rate=lr, num_components=K,
              num_central=V1, update_mode=mode, bias_mode=bias_mode)
    jfn = jax.jit(functools.partial(jglove._glove_epoch, optimizer=jopt,
                                    **kw))
    jst = [jnp.asarray(a) for a in st0]
    jst = jst + [jopt.init(jst[0]), jopt.init(jst[1]),
                 jnp.ones_like(jst[2]), jnp.ones_like(jst[3])]
    opt = ct.optim.AdaGrad(lr)
    tst = [_t(a.copy()) for a in st0]
    tst = tst + [opt.init(tst[0]), opt.init(tst[1]),
                 torch.ones_like(tst[2]), torch.ones_like(tst[3])]
    for e in range(2):
        *jst, jloss = jfn(*jst, jnp.asarray(c2), jnp.asarray(x2),
                          jnp.asarray(n2), jnp.asarray(N, jnp.int32))
        loss = tglove._glove_epoch(*tst, _t(c2), _t(x2), _t(n2), N,
                                   optimizer=opt, **kw)
        for name, got, want in zip(("Wc", "Wx", "bc", "bx"), tst, jst):
            _close(got, want, "adagrad", lr, f"{name}, epoch {e}")
        for name, got, want in (("ow", tst[4], jst[4]), ("oh", tst[5],
                                                         jst[5])):
            _close(got["accum"], want["accum"], "adagrad", lr, name)
        _close(tst[6], jst[6], "adagrad", lr, "abc")
        _close(tst[7], jst[7], "adagrad", lr, "abx")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    if bias_mode == "fused":
        assert (tst[0][:, K + 1] == 1).all() and (tst[1][:, K] == 1).all()


@pytest.mark.parametrize("optimizer,lr,mode", [
    ("sgd", 0.05, "auto"), ("adagrad", 0.05, "sparse"),
    ("adam", 0.01, "auto")])
def test_bpr_fit_matches_jax(data, one_device, monkeypatch, optimizer, lr,
                             mode):
    """Whole ``BPR(packed="off")`` fits, two epochs, the port's draws
    replaced by the JAX fit's (batch 256: 15 steps, the last padded)."""
    kw = dict(num_components=12, learning_rate=lr, optimizer=optimizer,
              weight_decay=0.01, batch_size=256, update_mode=mode,
              packed="off")
    mj = cymf_tpu.BPR(**kw)
    mj.fit(data.train, num_epochs=2, verbose=False, seed=5)
    N = data.train.nnz
    S = -(-N // 256)
    _feed(monkeypatch, tbpr, "_draw_negatives",
          _bpr_draws(5, 2, S, 256, data.train.shape[1]))
    mt = ct.BPR(device="cpu", **kw)
    mt.fit(data.train, num_epochs=2, verbose=False, seed=5)
    assert mt.engine_ == "batch" and len(mt.epoch_times_) == 2
    assert mt.update_mode_ == ("sparse" if mode == "sparse" else "dense")
    _close(mt.W, mj.W, optimizer, lr, "W")
    _close(mt.H, mj.H, optimizer, lr, "H")
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-5)


@pytest.mark.parametrize("binary,K", [(True, 8), (False, 8), (True, 127)])
def test_relmf_fit_matches_jax(data, one_device, monkeypatch, binary, K):
    """Whole RelMF fits on the batch engine, two epochs, the port's draws
    replaced by the JAX fit's: ``packed="off"`` on a binary ``X``, and
    under ``"auto"`` the two fits only the batch engine takes, a
    non-binary ``X`` and ``num_components=127``."""
    X = sparse.csr_matrix(data.train).astype(np.float64)
    if not binary:
        X.data[:] = np.random.default_rng(4).integers(1, 5, X.nnz)
    packed = "off" if (binary and K < 127) else "auto"
    kw = dict(num_components=K, learning_rate=0.01, weight_decay=0.01,
              batch_size=4096, packed=packed)
    mj = cymf_tpu.RelMF(**kw)
    mj.fit(X, num_epochs=2, verbose=False, seed=5)
    U, I = X.shape
    S = -(-U * I // 4096)
    _feed(monkeypatch, trelmf, "_draw_cells",
          _relmf_draws(5, 2, S, 4096, U, I))
    mt = ct.RelMF(device="cpu", **kw)
    mt.fit(X, num_epochs=2, seed=5)
    assert mt.packed_engine_ is False and mt._samples_per_epoch == S * 4096
    _close(mt.W, mj.W, "adam", 0.01, "W")
    _close(mt.H, mj.H, "adam", 0.01, "H")
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-5)


def _toy_cooc(V=120, seed=3):
    """The co-occurrence matrix of ``tests/test_glove.py``."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((V, V))
    mask = rng.random((V, V)) < 0.2
    dense[mask] = rng.integers(1, 50, size=mask.sum())
    np.fill_diagonal(dense, 0)
    return sparse.csr_matrix(dense)


@pytest.mark.parametrize("kwargs", [
    dict(packed="off"), dict(bias_mode="kfold"),
    dict(bias_mode="kfold", packed="off", update_mode="sparse"),
    dict(num_components=125)])
def test_glove_fit_matches_jax(one_device, kwargs):
    """Whole GloVe fits on the batch engine under the same
    ``np.random.seed`` (no draws), three epochs of batch 512 (6 steps, the
    last padded): ``packed="off"``, and the fits only the batch engine
    takes, kfold and ``num_components=125``."""
    X = _toy_cooc()
    kw = dict(num_components=8, learning_rate=0.05, batch_size=512)
    kw.update(kwargs)
    np.random.seed(7)
    mj = cymf_tpu.GloVe(**kw)
    mj.fit(X, num_epochs=3)
    np.random.seed(7)
    mt = ct.GloVe(device="cpu", **kw)
    mt.fit(X, num_epochs=3)
    assert mt.packed_engine_ is False and len(mt.epoch_times_) == 3
    for name in ("W_central", "W_context", "bias", "context_bias", "W"):
        _close(getattr(mt, name), getattr(mj, name), "adagrad", 0.05, name)
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-5)
    assert all((c == 1).all() for c in mt.constant_columns_)


def test_batch_state_from_jax(data, one_device, monkeypatch):
    """A JAX batch-engine state after one Adam epoch, carried across: one
    more port epoch on it equals one more JAX epoch."""
    X = sparse.csr_matrix(data.train)
    U, I = X.shape
    u2, i2 = _bpr_streams(X, 512, seed=3)
    S, B = u2.shape
    lr = 0.01
    jopt = j_make_optimizer("adam", lr)
    jfn = jax.jit(functools.partial(
        jbpr._bpr_epoch, optimizer=jopt, weight_decay=0.01, num_users=U,
        num_items=I, update_mode="dense"))
    coo = X.tocoo()
    hs_j = j_hashset(coo.row, coo.col)
    jst = [jnp.asarray(_init((U, 10), 5)), jnp.asarray(_init((I, 10), 6))]
    jst += [jopt.init(jst[0]), jopt.init(jst[1])]
    args = (jnp.asarray(u2), jnp.asarray(i2), hs_j,
            jnp.asarray(X.nnz, jnp.int32))
    *jst, _ = jfn(*jst, *args, jax.random.fold_in(jax.random.PRNGKey(2), 0))
    W, H, ow, oh = batch_state_from_jax(
        *(np.asarray(a) for a in jst[:2]),
        *({k: np.asarray(v) for k, v in d.items()} for d in jst[2:]), "cpu")
    assert set(ow) == {"m", "v"} and W.dtype == torch.float32
    *jst, jloss = jfn(*jst, *args,
                      jax.random.fold_in(jax.random.PRNGKey(2), 1))
    _feed(monkeypatch, tbpr, "_draw_negatives",
          _bpr_draws(2, 2, S, B, I)[S:])
    loss = tbpr._bpr_epoch(
        W, H, ow, oh, _t(u2), _t(i2),
        to_device(build_pair_hashset(coo.row, coo.col), "cpu"), X.nnz,
        None, optimizer=make_optimizer("adam", lr), weight_decay=0.01,
        num_users=U, num_items=I, update_mode="dense")
    _close(W, jst[0], "adam", lr, "W")
    _close(H, jst[1], "adam", lr, "H")
    for k in ("m", "v"):
        _close(ow[k], jst[2][k], "adam", lr, k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        batch_state_from_jax(np.zeros((3, 2)), np.zeros((4, 2)),
                             {"accum": np.ones((3, 3))}, {}, "cpu")


@pytest.mark.parametrize("device_type,n,packed,K,want", [
    ("cpu", 10, "auto", 20, "packed"),        # the CPU: fused at any size
    ("cuda", 4095, "auto", 20, "batch"),
    ("cuda", 4096, "auto", 20, "packed"),
    ("cuda", 4095, "auto", 128, "batch"),
    ("cuda", 4096, "auto", 128, "wide"),
    ("cuda", 10, "on", 20, "packed"),
    ("cuda", 10**7, "off", 20, "batch"),
    ("cpu", 10, "off", 128, "batch"),
])
def test_bpr_routing(device_type, n, packed, K, want):
    assert ct.BPR(K, packed=packed, device="cpu")._fused_engine(
        device_type, n) == want


@pytest.mark.parametrize("device_type,n,kwargs,want", [
    ("cpu", 10, {}, True),
    ("cuda", 4095, {}, False),
    ("cuda", 4096, {}, True),
    ("cuda", 10, dict(packed="on"), True),
    ("cuda", 10**7, dict(packed="off"), False),
    ("cpu", 10**7, dict(bias_mode="kfold"), False),
    ("cpu", 10**7, dict(num_components=125), False),
])
def test_glove_routing(device_type, n, kwargs, want):
    assert ct.GloVe(device="cpu", **kwargs)._packed_engine(
        device_type, n) is want


@pytest.mark.parametrize("kwargs", [dict(bias_mode="kfold"),
                                    dict(num_components=125)])
def test_glove_packed_on_refuses_what_it_cannot_run(kwargs):
    with pytest.raises(ValueError, match="124"):
        ct.GloVe(packed="on", device="cpu", **kwargs).fit(_toy_cooc(10), 1)


def test_relmf_routing(monkeypatch):
    m = ct.RelMF(8, device="cpu")
    assert m._packed_engine(True, 10) is True
    assert m._packed_engine(False, 10) is False        # non-binary X
    assert ct.RelMF(127, device="cpu")._packed_engine(True, 10) is False
    assert ct.RelMF(8, packed="off", device="cpu")._packed_engine(
        True, 10) is False
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    cap = trelmf.HOST_PREP_MAX_CELLS
    assert m._packed_engine(True, cap) is True
    assert m._packed_engine(True, cap + 1) is False


def test_small_fits_route_by_device(data):
    """On the CPU ``"auto"`` keeps the fused engines at any size; a fit
    that ``packed="off"`` sends to the batch engine learns its tables on
    the model's device and publishes them as numpy."""
    m = ct.BPR(8, device="cpu")
    m.fit(data.train[:20], num_epochs=1, verbose=False)
    assert data.train[:20].nnz < 4096 and m.engine_ == "packed"
    m = ct.BPR(8, packed="off", device="cpu")
    m.fit(data.train, num_epochs=1, verbose=False)
    assert m.engine_ == "batch" and isinstance(m.W, np.ndarray)
    assert np.isfinite(m.last_loss) and m._state is None


# -- convergence gates: the batch engines against the sequential replicas --

def _replicas():
    import test_reference_parity as ref
    return ref


def test_bpr_batch_engine_matches_sequential_reference_quality():
    """3-seed mean quality within 0.012 of the sequential replica, both
    above the floors (`tests/test_reference_parity.py:66-93`)."""
    ref = _replicas()
    data = SyntheticImplicitDataset(num_user=150, num_item=100, rank=4,
                                    density=0.12, seed=21)
    X = sparse.csr_matrix(data.train).astype(np.float64)
    ev = ct.AoaEvaluator(data.test, data.train, k=5, device="cpu")
    K, lr, wd, epochs = 10, 0.01, 0.01, 60
    refs, gots = [], []
    for s in range(3):
        W_ref, H_ref = ref._sequential_bpr(X, K, lr, wd, epochs,
                                           sample_seed=1234 + s)
        refs.append(ref._eval_mean(ev, W_ref, H_ref))
        model = ct.BPR(num_components=K, learning_rate=lr, weight_decay=wd,
                       batch_size=256, packed="off", device="cpu")
        model.fit(X, num_epochs=epochs, verbose=False, seed=1234 + s)
        assert model.engine_ == "batch"
        gots.append(ref._eval_mean(ev, model.W, model.H))
    floors = {"DCG@5": 0.17, "Recall@5": 0.22, "MAP@5": 0.15}
    for key in ("DCG@5", "Recall@5", "MAP@5"):
        g = np.mean([r[key] for r in gots])
        r = np.mean([r[key] for r in refs])
        assert g > r - 0.012, (key, g, r)
        assert r > floors[key] and g > floors[key], (key, g, r)


def test_relmf_batch_engine_matches_sequential_reference_quality():
    """Within 0.02 of the per-cell replica
    (`tests/test_reference_parity.py:134-154`)."""
    ref = _replicas()
    data = SyntheticImplicitDataset(num_user=80, num_item=60, rank=4,
                                    density=0.15, seed=5)
    X = sparse.csr_matrix(data.train).astype(np.float64)
    ev = ct.AoaEvaluator(data.test, data.train, k=5, device="cpu")
    K, lr, wd, clip, epochs = 8, 0.01, 0.01, 0.1, 20
    W_ref, H_ref = ref._sequential_relmf(X, K, lr, wd, clip, epochs)
    want = ev.evaluate(W_ref, H_ref)
    model = ct.RelMF(num_components=K, learning_rate=lr, weight_decay=wd,
                     clip_value=clip, batch_size=1024, packed="off",
                     device="cpu")
    model.fit(X, num_epochs=epochs, verbose=False)
    assert model.packed_engine_ is False
    got = ev.evaluate(model.W, model.H)
    for key in ("DCG@5", "Recall@5", "MAP@5"):
        assert got[key] > want[key] - 0.02, (key, got[key], want[key])


def test_glove_batch_engine_matches_sequential_reference_loss():
    """kfold at batch 256 reaches the per-triple replica's training loss
    (`tests/test_reference_parity.py:194-215`)."""
    ref = _replicas()
    rng = np.random.default_rng(11)
    V = 60
    dense = (rng.random((V, V)) < 0.25) * rng.integers(1, 40, (V, V))
    np.fill_diagonal(dense, 0)
    X = sparse.csr_matrix(dense.astype(np.float64))
    K, lr, epochs = 8, 0.05, 25
    _, ref_loss = ref._sequential_glove(X, K, lr, x_max=10.0, alpha=0.75,
                                        num_epochs=epochs)
    np.random.seed(7)
    model = ct.GloVe(num_components=K, learning_rate=lr, x_max=10.0,
                     alpha=0.75, batch_size=256, bias_mode="kfold",
                     device="cpu")
    model.fit(X, num_epochs=epochs, verbose=False)
    assert model.packed_engine_ is False and model.last_loss is not None
    assert model.last_loss < ref_loss * 1.15 + 0.01, \
        (model.last_loss, ref_loss)
