"""The port's checkpoints and resume, against ``cymf_tpu``'s.

The unit tests are the port counterparts of ``tests/test_checkpoint.py``'s.
A resumed fit must equal the uninterrupted one within that file's
tolerances (``rtol 1e-4, atol 1e-4``) on every engine that saves state;
the cross-engine and row-padding resumes follow its BPR tests.

Across the packages, a checkpoint written by one resumes in the other:
with ``num_epochs`` equal to the saved epochs the resumed model holds the
saved tables (``rtol 1e-5, atol 1e-6``), and one further epoch matches the
other package's uninterrupted fit within the port/JAX tolerances of the
model's own test file (``tests/test_torch_{bpr,relmf,glove,wmf,expomf,
batch_engine}.py``), the Adam first-touch allowance included.  The JAX
side runs on one device with the numpy prep stream (and host prep for
RelMF's packed engine), as those files pin it; the batch engines' draws
are replaced by the JAX package's threefry draws
(``tests/test_torch_batch_engine.py``).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.models import bpr as tbpr
from cymf_tpu_torch.models import relmf as trelmf
from cymf_tpu_torch.utils.checkpoint import (AsyncCheckpointer,
                                             load_checkpoint,
                                             save_checkpoint)

TOL = dict(rtol=1e-4, atol=1e-4)            # resumed against uninterrupted
SAVED = dict(rtol=1e-5, atol=1e-6)          # the saved tables, reproduced


@pytest.fixture(autouse=True)
def _one_torch_thread_numpy_prep(monkeypatch):
    """One torch thread a test (the suite runs in parallel workers), and
    both packages on the numpy prep stream."""
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_device():
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


# -- the checkpoint files --------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    state = {"W": torch.arange(12.0).reshape(3, 4),
             "opt": {"m": torch.ones((3, 4)), "v": torch.zeros((3, 4))}}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, epoch=7, meta={"lr": 0.01})
    loaded, epoch, meta = load_checkpoint(p, state)
    assert epoch == 7
    assert float(meta["lr"]) == pytest.approx(0.01)
    assert loaded["W"].dtype == torch.float32
    torch.testing.assert_close(loaded["W"], state["W"])
    torch.testing.assert_close(loaded["opt"]["v"], torch.zeros((3, 4)))
    with np.load(p) as z:
        assert sorted(z.files) == ["W", "__epoch__", "__meta__/lr", "opt/m",
                                   "opt/v"]
        assert z["__epoch__"].dtype == np.int64


def test_load_missing_leaf_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, {"a": torch.zeros(2)}, epoch=0)
    with pytest.raises(KeyError, match="'b'"):
        load_checkpoint(p, {"a": torch.zeros(2), "b": torch.zeros(3)})


def test_load_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, {"b": torch.zeros((1, 1))}, epoch=0)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, {"b": torch.zeros((1,))})


def test_async_checkpointer_matches_sync(tmp_path):
    """``save`` + ``wait`` writes what the sync writer does, and the
    snapshot is of save-time state though the tensor is updated in place
    afterwards (as the packed engines update their tables)."""
    state = {"W": torch.arange(12.0).reshape(3, 4),
             "opt": {"m": torch.ones((3, 4))}}
    pa, ps = str(tmp_path / "async.npz"), str(tmp_path / "sync.npz")
    ck = AsyncCheckpointer()
    ck.save(pa, state, epoch=3, meta={"lr": 0.5})
    state["W"].add_(100.0)
    ck.wait()
    save_checkpoint(ps, {"W": torch.arange(12.0).reshape(3, 4),
                         "opt": {"m": torch.ones((3, 4))}}, epoch=3,
                    meta={"lr": 0.5})
    la, ea, ma = load_checkpoint(pa, state)
    ls, es, ms = load_checkpoint(ps, state)
    assert ea == es == 3 and float(ma["lr"]) == float(ms["lr"]) == 0.5
    torch.testing.assert_close(la["W"], ls["W"], rtol=0, atol=0)
    torch.testing.assert_close(la["opt"]["m"], ls["opt"]["m"], rtol=0,
                               atol=0)


def test_async_write_error_surfaces_on_wait(tmp_path):
    bad = AsyncCheckpointer()
    bad.save("/proc/definitely/not/writable/x.npz", {"W": torch.zeros(2)},
             epoch=0)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                                # reported once
    bad.save("/proc/definitely/not/writable/x.npz", {"W": torch.zeros(2)},
             epoch=1)
    with pytest.raises(OSError):
        bad.save(str(tmp_path / "ok.npz"), {"W": torch.zeros(2)}, epoch=2)


def test_files_load_across_packages(tmp_path):
    """The key format is the JAX package's: each package loads the
    other's file, nested keys, epoch and meta included."""
    from cymf_tpu.utils import checkpoint as jck
    state = {"W": np.arange(6.0, dtype=np.float32).reshape(2, 3),
             "ow": {"m": np.ones((2, 3), np.float32)}, "oh": {}}
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_checkpoint(pj, jax.tree_util.tree_map(jnp.asarray, state), 4,
                        meta={"k": 3})
    save_checkpoint(pt, {k: jax.tree_util.tree_map(torch.tensor, v)
                         for k, v in state.items()}, 4, meta={"k": 3})
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
    got, epoch, meta = load_checkpoint(pj, {"W": torch.zeros((2, 3)),
                                            "ow": {"m": torch.zeros((2, 3))},
                                            "oh": {}})
    assert epoch == 4 and int(meta["k"]) == 3 and got["oh"] == {}
    np.testing.assert_array_equal(got["W"].numpy(), state["W"])
    back, epoch, _ = jck.load_checkpoint(pt, state)
    assert epoch == 4
    np.testing.assert_array_equal(np.asarray(back["ow"]["m"]),
                                  state["ow"]["m"])


# -- resume inside the port -------------------------------------------------

def _mf_data(seed=4):
    return SyntheticImplicitDataset(num_user=80, num_item=50, rank=4,
                                    density=0.15, seed=seed).train


def _cooc(seed=4, V=40):
    rng = np.random.default_rng(seed)
    dense = (rng.random((V, V)) < 0.2) * rng.integers(1, 20, (V, V))
    np.fill_diagonal(dense, 0)
    return sparse.csr_matrix(dense.astype(np.float64))


_BPR = dict(num_components=6, learning_rate=0.02, batch_size=128)
_RELMF = dict(num_components=6, learning_rate=0.02, batch_size=512)
_GLOVE = dict(num_components=6, learning_rate=0.05, batch_size=128)
# name: (model, constructor arguments, environment, what the fit reports)
_ENGINES = {
    "bpr": ("BPR", _BPR, {}, dict(engine_="packed", packed_kernel_=5)),
    "bpr-v4": ("BPR", _BPR, {"CYMF_TPU_PACKED_KERNEL": "4"},
               dict(packed_kernel_=4)),
    "bpr-v7": ("BPR", _BPR, {"CYMF_TPU_PACKED_KERNEL": "7"},
               dict(packed_kernel_=7)),
    "bpr-pool": ("BPR", dict(_BPR, neg_pool=128), {},
                 dict(packed_kernel_=8)),
    "bpr-wide": ("BPR", dict(_BPR, num_components=128), {},
                 dict(engine_="wide")),
    "bpr-batch": ("BPR", dict(_BPR, packed="off"), {},
                  dict(engine_="batch")),
    "relmf": ("RelMF", _RELMF, {}, dict(prep_backend_="device-torch")),
    "relmf-host": ("RelMF", _RELMF, {"CYMF_TPU_RELMF_PREP": "host"},
                   dict(prep_backend_="numpy")),
    "relmf-batch": ("RelMF", dict(_RELMF, packed="off"), {},
                    dict(packed_engine_=False)),
    "wmf": ("WMF", dict(num_components=6), {}, {}),
    "expomf": ("ExpoMF", dict(num_components=6), {}, {}),
    "glove": ("GloVe", _GLOVE, {}, dict(packed_engine_=True)),
    "glove-batch": ("GloVe", dict(_GLOVE, packed="off"), {},
                    dict(packed_engine_=False)),
    "glove-kfold": ("GloVe", dict(_GLOVE, bias_mode="kfold"), {},
                    dict(packed_engine_=False)),
}


def _tables(m):
    if isinstance(m, (ct.GloVe, cymf_tpu.GloVe)):
        return {"W_central": m.W_central, "W_context": m.W_context,
                "bias": m.bias, "context_bias": m.context_bias}
    out = {"W": m.W, "H": m.H}
    if isinstance(m, (ct.ExpoMF, cymf_tpu.ExpoMF)):
        out["mu"] = m.mu
    return out


@pytest.mark.parametrize("name", list(_ENGINES))
def test_resume_matches_uninterrupted(tmp_path, monkeypatch, name):
    """6 epochs against 3 with a checkpoint and 3 more resumed from it,
    on every engine that saves state."""
    cls, kw, env, want = _ENGINES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    X = _cooc() if cls == "GloVe" else _mf_data()
    p = str(tmp_path / f"{name}.npz")

    def fit(epochs, **ck):
        np.random.seed(99)      # GloVe's init reads the ambient stream
        m = getattr(ct, cls)(device="cpu", **kw)
        m.fit(X, num_epochs=epochs, verbose=False, **ck)
        return m

    m1 = fit(6)
    m2 = fit(3, checkpoint_path=p)
    m3 = fit(6, checkpoint_path=p, resume=True)
    for attr, v in want.items():
        assert getattr(m3, attr) == v, attr
    assert len(m2.checkpoint_s_) == 3 and len(m3.checkpoint_s_) == 3
    if hasattr(m3, "epoch_times_"):                # ExpoMF keeps none
        assert len(m3.epoch_times_) == 3
    with np.load(p) as z:
        assert int(z["__epoch__"]) == 5
    for k, got in _tables(m3).items():
        np.testing.assert_allclose(got, _tables(m1)[k], err_msg=k, **TOL)


def test_checkpoint_every(tmp_path):
    p = str(tmp_path / "every.npz")
    m = ct.BPR(device="cpu", **_BPR)
    m.fit(_mf_data(), num_epochs=5, verbose=False, checkpoint_path=p,
          checkpoint_every=2)
    assert len(m.checkpoint_s_) == 2
    with np.load(p) as z:
        assert int(z["__epoch__"]) == 3


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("src,dst", [("on", "off"), ("off", "on")])
def test_bpr_cross_engine_resume(tmp_path, src, dst, optimizer):
    """A packed checkpoint resumes on the batch engine and the other way:
    with num_epochs == the saved epochs the tables come back as saved,
    and one further epoch trains through the converted moments."""
    X = sparse.random(120, 70, density=0.2, random_state=3, format="csr")
    X.data[:] = 1.0
    kw = dict(_BPR, optimizer=optimizer, device="cpu")
    p = str(tmp_path / f"ck_{src}_{optimizer}.npz")
    m1 = ct.BPR(packed=src, **kw)
    m1.fit(X, num_epochs=2, verbose=False, seed=7, checkpoint_path=p)
    m2 = ct.BPR(packed=dst, **kw)
    m2.fit(X, num_epochs=2, verbose=False, seed=7, checkpoint_path=p,
           resume=True)
    assert m2.checkpoint_s_ == []                       # no epoch ran
    assert m2.engine_ == ("batch" if dst == "off" else "packed")
    np.testing.assert_allclose(m2.W, m1.W, **SAVED)
    np.testing.assert_allclose(m2.H, m1.H, **SAVED)
    m3 = ct.BPR(packed=dst, **kw)
    m3.fit(X, num_epochs=3, verbose=False, seed=7, checkpoint_path=p,
           resume=True)
    assert np.isfinite(m3.W).all() and np.isfinite(m3.H).all()
    assert not np.allclose(m3.W, m1.W)


def test_bpr_wide_cross_engine_resume(tmp_path):
    """K >= 128: a batch-engine checkpoint resumes on the wide engine and
    the other way."""
    X = sparse.random(200, 120, density=0.12, random_state=5, format="csr")
    X.data[:] = 1.0
    kw = dict(num_components=128, learning_rate=0.02, batch_size=1024,
              device="cpu")
    for src, dst in (("off", "on"), ("on", "off")):
        p = str(tmp_path / f"cw_{src}.npz")
        m1 = ct.BPR(packed=src, **kw)
        m1.fit(X, num_epochs=2, verbose=False, seed=7, checkpoint_path=p)
        m2 = ct.BPR(packed=dst, **kw)
        m2.fit(X, num_epochs=2, verbose=False, seed=7, checkpoint_path=p,
               resume=True)
        np.testing.assert_allclose(m2.W, m1.W, **SAVED)
        np.testing.assert_allclose(m2.H, m1.H, **SAVED)
        m3 = ct.BPR(packed=dst, **kw)
        m3.fit(X, num_epochs=3, verbose=False, seed=7, checkpoint_path=p,
               resume=True)
        assert m3.engine_ == ("wide" if dst == "on" else "batch")
        assert np.isfinite(m3.W).all() and not np.allclose(m3.W, m1.W)


@pytest.mark.parametrize("engine,K", [("off", 6), ("on", 6), ("on", 128)])
def test_bpr_resume_across_row_padding(tmp_path, engine, K):
    """Every leaf of a checkpoint carries 64 extra zero rows (a foreign
    row padding): tables and same-engine optimizer leaves slice and
    re-pad, and the resumed epoch equals an uninterrupted fit's."""
    X = sparse.random(120, 70, density=0.2, random_state=3, format="csr")
    X.data[:] = 1.0
    kw = dict(_BPR, num_components=K, packed=engine, device="cpu")
    p = str(tmp_path / "ck.npz")
    ct.BPR(**kw).fit(X, num_epochs=2, verbose=False, seed=7,
                     checkpoint_path=p)
    m2 = ct.BPR(**kw)
    m2.fit(X, num_epochs=3, verbose=False, seed=7)
    with np.load(p) as z:
        flat = {k: z[k] for k in z.files}
    for k, v in list(flat.items()):
        if v.ndim == 2:
            flat[k] = np.pad(v, ((0, 64), (0, 0)))
    np.savez(p, **flat)
    m3 = ct.BPR(**kw)
    m3.fit(X, num_epochs=3, verbose=False, seed=7, checkpoint_path=p,
           resume=True)
    assert len(m3.checkpoint_s_) == 1                   # one epoch ran
    np.testing.assert_allclose(m3.W, m2.W, **SAVED)
    np.testing.assert_allclose(m3.H, m2.H, **SAVED)


@pytest.mark.parametrize("src,dst", [("on", "off"), ("off", "on")])
def test_relmf_cross_engine_resume(tmp_path, src, dst):
    """RelMF's packed checkpoint resumes on its batch engine and the other
    way; the packed engine under device prep rebuilds lane K of its item
    table (``1/max(p_i, M)``) from the propensities."""
    X = _mf_data()
    p = str(tmp_path / f"r_{src}.npz")
    m1 = ct.RelMF(packed=src, device="cpu", **_RELMF)
    m1.fit(X, num_epochs=2, seed=7, checkpoint_path=p)
    m2 = ct.RelMF(packed=dst, device="cpu", **_RELMF)
    m2.fit(X, num_epochs=2, seed=7, checkpoint_path=p, resume=True)
    np.testing.assert_allclose(m2.W, m1.W, **SAVED)
    np.testing.assert_allclose(m2.H, m1.H, **SAVED)
    m3 = ct.RelMF(packed=dst, device="cpu", **_RELMF)
    m3.fit(X, num_epochs=3, seed=7, checkpoint_path=p, resume=True)
    assert np.isfinite(m3.W).all() and not np.allclose(m3.W, m1.W)
    assert np.isfinite(m3.last_loss)


# -- across the packages ----------------------------------------------------

def _bpr_draws(seed, epochs, S, B, I):
    """The JAX batch engine's negatives of ``epochs``: step ``s`` of epoch
    ``e`` draws from ``fold_in(fold_in(PRNGKey(seed), e), s)``."""
    out = []
    for e in epochs:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            out.append(np.asarray(jax.random.randint(
                jax.random.fold_in(key, s), (B,), 0, I, dtype=jnp.int32)))
    return out


def _relmf_draws(seed, epochs, S, B, U, I):
    """The JAX batch engine's cells: a split of the step key into the
    user and the item draw."""
    out = []
    for e in epochs:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            ku, ki = jax.random.split(jax.random.fold_in(key, s))
            out.append(tuple(np.asarray(jax.random.randint(
                k, (B,), 0, n, dtype=jnp.int32)) for k, n in ((ku, U),
                                                              (ki, I))))
    return out


def _feed(monkeypatch, module, name, draws):
    """``module.name`` hands out ``draws`` in order, one a call."""
    it = iter(draws)

    def draw(gen, B, *args):
        d = next(it)
        return tuple(torch.tensor(a) for a in d) if isinstance(d, tuple) \
            else torch.tensor(d)

    monkeypatch.setattr(module, name, draw)


def _adam_close(got, want, lr, rtol, atol, what):
    """The Adam first-touch allowance: at least 99% of elements within
    the tolerance, every element within ``3 lr``."""
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    assert ok.mean() >= 0.99, (what, ok.mean())
    assert np.abs(got - want).max() <= 3 * lr, what


SEED = 7
# name: (model, arguments of both packages, the JAX side's, the port's,
# environment, the port/JAX tolerance of one further epoch)
_CROSS = {
    "bpr": ("BPR", _BPR, dict(packed="on"), {}, {}, "adam"),
    "bpr-batch": ("BPR", dict(_BPR, packed="off"), {}, {}, {}, "adam-batch"),
    "relmf": ("RelMF", _RELMF, dict(packed="on"), {},
              {"CYMF_TPU_RELMF_PREP": "host"}, "adam"),
    "relmf-batch": ("RelMF", dict(_RELMF, packed="off"), {}, {}, {},
                    "adam-batch"),
    "glove": ("GloVe", _GLOVE, dict(packed="on"), {}, {}, "glove"),
    "wmf": ("WMF", dict(num_components=6), {}, {}, {}, "als"),
    "expomf": ("ExpoMF", dict(num_components=6), {}, {}, {}, "als"),
}


def _further_close(got, want, kind, lr, what):
    if kind == "adam":           # tests/test_torch_{bpr,relmf}.py
        _adam_close(got, want, lr, 1e-3, 1e-4, what)
    elif kind == "adam-batch":   # tests/test_torch_batch_engine.py
        _adam_close(got, want, lr, 1e-4, 1e-5, what)
    elif kind == "glove":        # tests/test_torch_glove.py
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                   err_msg=what)
    else:                        # tests/test_torch_{wmf,expomf}.py
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4,
                                   err_msg=what)


def _cross_fit(pkg, name, X, epochs, monkeypatch, **ck):
    """A fit of case ``name`` in ``pkg`` (``cymf_tpu`` on one device, or
    the port on the CPU with the batch engines fed JAX's draws for the
    epochs it runs)."""
    cls, kw, jkw, tkw, env, _ = _CROSS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seed = dict(seed=SEED) if cls in ("BPR", "RelMF") else {}
    np.random.seed(99)
    if pkg is cymf_tpu:
        m = getattr(cymf_tpu, cls)(**kw, **jkw)
        m.fit(X, num_epochs=epochs, verbose=False, **seed, **ck)
        return m
    start = 0
    if ck.get("resume"):
        with np.load(ck["checkpoint_path"]) as z:
            start = int(z["__epoch__"]) + 1
    if name == "bpr-batch":
        B = kw["batch_size"]
        _feed(monkeypatch, tbpr, "_draw_negatives", _bpr_draws(
            SEED, range(start, epochs), -(-X.nnz // B), B, X.shape[1]))
    elif name == "relmf-batch":
        B = kw["batch_size"]
        U, I = X.shape
        _feed(monkeypatch, trelmf, "_draw_cells", _relmf_draws(
            SEED, range(start, epochs), -(-U * I // B), B, U, I))
    m = getattr(ct, cls)(device="cpu", **kw, **tkw)
    m.fit(X, num_epochs=epochs, verbose=False, **seed, **ck)
    return m


def _saved_epochs(monkeypatch):
    """The epochs each package's fits save from now on, in order: one a
    completed epoch under ``checkpoint_every=1``."""
    from cymf_tpu.utils import checkpoint as jck
    from cymf_tpu_torch.utils import checkpoint as tck
    epochs = []
    for mod in (jck, tck):
        def save(self, path, state, epoch, meta=None,
                 _real=mod.AsyncCheckpointer.save):
            epochs.append(epoch)
            return _real(self, path, state, epoch, meta)
        monkeypatch.setattr(mod.AsyncCheckpointer, "save", save)
    return epochs


@pytest.mark.parametrize("src", ["jax", "torch"])
@pytest.mark.parametrize("name", list(_CROSS))
def test_resume_across_packages(tmp_path, one_device, monkeypatch, name,
                                src):
    """A checkpoint one package writes after 2 epochs resumes in the
    other: at num_epochs=2 the resumed model runs no epoch and holds the
    saved tables, and its third epoch (the only one it runs) matches the
    writer's uninterrupted 3-epoch fit."""
    cls = _CROSS[name][0]
    X = _cooc() if cls == "GloVe" else _mf_data()
    writer, reader = (cymf_tpu, ct) if src == "jax" else (ct, cymf_tpu)
    p = str(tmp_path / f"{name}.npz")
    saved = _cross_fit(writer, name, X, 2, monkeypatch, checkpoint_path=p)
    ran = _saved_epochs(monkeypatch)
    again = _cross_fit(reader, name, X, 2, monkeypatch, checkpoint_path=p,
                       resume=True)
    assert ran == []
    for k, want in _tables(saved).items():
        np.testing.assert_allclose(_tables(again)[k], want, err_msg=k,
                                   **SAVED)
    whole = _cross_fit(writer, name, X, 3, monkeypatch)
    on = _cross_fit(reader, name, X, 3, monkeypatch, checkpoint_path=p,
                    resume=True)
    assert ran == [2]
    lr = _CROSS[name][1].get("learning_rate", 0.0)
    for k, want in _tables(whole).items():
        _further_close(_tables(on)[k], want, _CROSS[name][5], lr, k)


def test_jax_padded_batch_checkpoint_resumes_in_port(tmp_path, monkeypatch):
    """A batch checkpoint written on the JAX package's 8-device CPU mesh
    carries tables padded to a multiple of 8 rows; the port's batch and
    packed engines resume it through ``repad``."""
    assert len(jax.devices()) == 8
    X = SyntheticImplicitDataset(num_user=83, num_item=51, rank=4,
                                 density=0.15, seed=4).train
    p = str(tmp_path / "mesh8.npz")
    mj = cymf_tpu.BPR(packed="off", **_BPR)
    mj.fit(X, num_epochs=2, verbose=False, seed=SEED, checkpoint_path=p)
    with np.load(p) as z:
        assert z["W"].shape == (88, 6) and z["oh/m"].shape == (56, 6)
    for packed in ("off", "on"):
        mt = ct.BPR(packed=packed, device="cpu", **_BPR)
        mt.fit(X, num_epochs=2, verbose=False, seed=SEED, checkpoint_path=p,
               resume=True)
        np.testing.assert_allclose(mt.W, mj.W, **SAVED)
        np.testing.assert_allclose(mt.H, mj.H, **SAVED)
        q = str(tmp_path / f"next_{packed}.npz")
        shutil.copy(p, q)      # the further epoch writes its own state
        mr = ct.BPR(packed=packed, device="cpu", **_BPR)
        mr.fit(X, num_epochs=3, verbose=False, seed=SEED, checkpoint_path=q,
               resume=True)
        assert mr.W.shape == (83, 6) and np.isfinite(mr.W).all()
        assert not np.allclose(mr.W, mj.W)
