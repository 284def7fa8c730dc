"""The port's native epoch prep (``cymf_tpu_torch.native``) against the JAX
package's C++ extension, ``cymf_tpu/native/_native.cpp``.

A module fixture builds the JAX package's source with the same ``g++``
into a temporary directory (never into ``cymf_tpu/native/``) and installs
it as ``cymf_tpu.native._native`` with ``HAVE_NATIVE`` true for this
module's tests.  Both copies then draw the same mt19937_64 streams, which
also depend on the C++ standard library's ``uniform_int_distribution``,
so every entry point and every prep function built on them is held to the
JAX package's bit for bit, at 1 and at 4 OpenMP threads.  Whole fits on
the same native streams are held to the JAX fits within the tolerances of
``tests/test_torch_bpr.py``: ``rtol 1e-3, atol 1e-4`` under sgd (the JAX
fit's bf16 hi+lo expansion and accumulation), and under Adam 99% of
elements to that and every element within ``3 lr``.
"""

import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cymf_tpu
import cymf_tpu.native
import cymf_tpu_torch as ct
from cymf_tpu.ops import packed_epoch as jpe
from cymf_tpu.ops import relmf_epoch as jre
from cymf_tpu.parallel import MeshContext, use_mesh
from cymf_tpu_torch import native
from cymf_tpu_torch.dataset import SyntheticImplicitDataset
from cymf_tpu_torch.models import bpr as tbpr
from cymf_tpu_torch.ops import glove_epoch as tge
from cymf_tpu_torch.ops import packed as pk
from cymf_tpu_torch.ops import packed_epoch as tpe
from cymf_tpu_torch.ops import relmf_epoch as tre
from cymf_tpu_torch.ops import wide_epoch as twe
from cymf_tpu_torch.parallel import MeshContext as TorchMesh
from cymf_tpu_torch.parallel import use_mesh as use_torch_mesh

ROOT = Path(__file__).resolve().parent.parent
U, I, K, S, B, WROWS = 300, 200, 20, 3, 2048, 128


@pytest.fixture(scope="session")
def _jax_extension(tmp_path_factory):
    """The JAX package's ``_native.cpp`` built with ``g++`` into a
    temporary directory and loaded as ``cymf_tpu.native._native``."""
    include = sysconfig.get_paths()["include"]
    if not Path(include, "Python.h").exists():
        pytest.skip("Python.h is absent: the JAX extension cannot be built")
    out = tmp_path_factory.mktemp("jax_native") / (
        "_native" + sysconfig.get_config_var("EXT_SUFFIX"))
    cmd = ["g++", "-O3", "-std=c++17", "-fopenmp", "-fPIC", "-shared",
           f"-I{include}", "-o", str(out),
           str(ROOT / "cymf_tpu" / "native" / "_native.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    spec = importlib.util.spec_from_file_location("cymf_tpu.native._native",
                                                  out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jn(_jax_extension):
    """The JAX extension, installed for this module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cymf_tpu.native._native", _jax_extension)
        mp.setattr(cymf_tpu.native, "_native", _jax_extension)
        mp.setattr(cymf_tpu.native, "HAVE_NATIVE", True)
        yield _jax_extension


@pytest.fixture(autouse=True)
def _native_env(monkeypatch):
    """The default stream on both sides, one torch thread (the suite runs
    in parallel workers) and the library's default thread count after."""
    monkeypatch.delenv("CYMF_TPU_PREP", raising=False)
    monkeypatch.delenv("CYMF_TPU_PACKED_KERNEL", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    native.set_num_threads(0)


@pytest.fixture(params=[1, 4], ids=["omp1", "omp4"])
def threads(request):
    assert native.set_num_threads(request.param) == request.param
    return request.param


def _problem(seed=0, pad=37):
    """User-sorted steps with a PAD_USER tail, items, and sorted positive
    keys with a dense first user (a long per-user range)."""
    rng = np.random.default_rng(seed)
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    u2[-1, -pad:] = np.int32(2**31 - 1)
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    keys = np.unique(np.concatenate([
        rng.integers(0, U, 6000).astype(np.int64) * I
        + rng.integers(0, I, 6000), np.arange(150, dtype=np.int64)]))
    return u2, i2, keys


def _filter_args(keys):
    kf = tpe.make_reject_filter(keys, U, I)
    assert kf is not None
    return kf


def _bits(out, dtypes):
    """The JAX extension's bytes results as arrays."""
    if isinstance(out, bytes):
        out = (out,)
    return [np.frombuffer(b, d) for b, d in zip(out, dtypes)]


def _equal(got, want, names):
    assert len(got) == len(want) == len(names)
    for g, w, n in zip(got, want, names):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        np.testing.assert_array_equal(g, w, err_msg=n)


PREP = ("j2", "mask", "sj", "rowsj", "winj")
PREP_T = (np.int32, np.float32, np.int32, np.int32, np.int32)
RELMF = ("u2", "i2", "lab", "winw", "si", "rowsi", "wini")
RELMF_T = (np.int32, np.int32, np.uint8, np.int32, np.int32, np.int32,
           np.int32)


# ---------------------------------------------------------------------------
# the eight entry points, bit for bit
# ---------------------------------------------------------------------------

def test_cooccurrence(jn, threads):
    rng = np.random.default_rng(4)
    lines = [rng.integers(0, 50, n) for n in rng.integers(0, 40, 60)]
    flat = np.concatenate(lines).astype(np.int64)
    lens = np.array([len(x) for x in lines], np.int64)
    got = native.cooccurrence(flat, lens, 50, 5)
    want = _bits(jn.cooccurrence(flat, lens, 50, 5), (np.int64, np.float64))
    assert len(got[0]) > 100
    _equal(got, want, ("keys", "vals"))


@pytest.mark.parametrize("seed", [5, -3, 2**62])
def test_bpr_prep_epoch_v2(jn, threads, seed):
    u2, _, keys = _problem()
    args = (S, B, U, I, 1, 256, WROWS, 1024, seed)
    got = native.bpr_prep_epoch_v2(u2, keys, *args)
    want = _bits(jn.bpr_prep_epoch_v2(u2, keys, *args), PREP_T)
    _equal(got, want, PREP)
    assert 0 < got[1].mean() < 1


@pytest.mark.parametrize("slots,rh", [(1, 256), (6, 128)])
def test_bpr_prep_epoch_v3(jn, threads, slots, rh):
    u2, _, keys = _problem(1)
    k, filt, indptr, lb = _filter_args(keys)
    args = (S, B, U, I, slots, rh, WROWS, 1024, 77)
    got = native.bpr_prep_epoch_v3(u2, k, indptr, filt, *args, lb)
    want = _bits(jn.bpr_prep_epoch_v3(u2, k, indptr, filt.tobytes(), *args,
                                      lb), PREP_T)
    _equal(got, want, PREP)
    # the filter changes the search, not the stream
    _equal(got, native.bpr_prep_epoch_v2(u2, keys, *args), PREP)


def test_pool_reject_all_forms(jn, threads, monkeypatch):
    u2, _, keys = _problem(2)
    rng = np.random.default_rng(2)
    j2 = rng.integers(0, I, u2.shape).astype(np.int32)
    k, filt, indptr, lb = _filter_args(keys)
    n = u2.size
    got = [native.pool_reject(u2, j2, keys, n, U, I),
           native.pool_reject_v2(u2, j2, keys, indptr, n, U, I),
           native.pool_reject_v3(u2, j2, keys, indptr, filt, n, U, I, lb)]
    want = [jn.pool_reject(u2, j2, keys, n, U, I),
            jn.pool_reject_v2(u2, j2, keys, indptr, n, U, I),
            jn.pool_reject_v3(u2, j2, keys, indptr, filt.tobytes(), n, U, I,
                              lb)]
    _equal(got, [np.frombuffer(w, np.float32) for w in want],
           ("v1", "v2", "v3"))
    _equal(got[1:], got[:1] * 2, ("v2", "v3"))
    # the numpy rejection, the port's only other path
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    np.testing.assert_array_equal(tpe._reject_mask(u2, j2, keys, U, I),
                                  got[0].reshape(u2.shape))
    assert 0 < got[0].mean() < 1


@pytest.mark.parametrize("log2_bits", [10, 17])
def test_build_key_filter(jn, threads, log2_bits):
    _, _, keys = _problem(3)
    got = native.build_key_filter(keys, log2_bits)
    want = np.frombuffer(jn.build_key_filter(keys, log2_bits), np.uint64)
    _equal([got], [want], ["filter"])
    assert got.any()


@pytest.mark.parametrize("Kr", [12, 40])
def test_relmf_prep_epoch(jn, threads, Kr):
    _, _, keys = _problem(4)
    k, filt, indptr, lb = _filter_args(keys)
    wrows = 16
    rw = pk.packed_rows(U, Kr, multiple=wrows)
    rh = pk.logical_rows(I, multiple=wrows)
    args = (S, 1024, U, I, pk.num_slots(Kr), rw, rh, wrows, wrows, 1024, 91,
            lb)
    got = native.relmf_prep_epoch(k, indptr, filt, *args)
    want = _bits(jn.relmf_prep_epoch(k, indptr, filt.tobytes(), *args),
                 RELMF_T)
    _equal(got, want, RELMF)
    assert 0 < got[2].sum() < got[2].size


# every entry point's outputs on fixed inputs, hashed: run here and in a
# fresh process under OMP_NUM_THREADS (numpy and the port's library only)
_DIGEST = """
import hashlib
import numpy as np
from cymf_tpu_torch import native


def digest(U=300, I=200, S=3, B=2048):
    rng = np.random.default_rng(5)
    u2 = np.sort(rng.integers(0, U + 9, (S, B)).astype(np.int32), axis=1)
    j2 = rng.integers(0, I, (S, B)).astype(np.int32)
    keys = np.unique(rng.integers(0, U * I, 6000).astype(np.int64))
    indptr = np.searchsorted(keys, np.arange(U + 1) * I).astype(np.int64)
    filt = native.build_key_filter(keys, 17)
    n = u2.size
    outs = [*native.bpr_prep_epoch_v2(u2, keys, S, B, U, I, 1, 256, 128,
                                      1024, 3),
            *native.bpr_prep_epoch_v3(u2, keys, indptr, filt, S, B, U, I, 1,
                                      256, 128, 1024, 3, 17),
            native.pool_reject(u2, j2, keys, n, U, I),
            native.pool_reject_v2(u2, j2, keys, indptr, n, U, I),
            native.pool_reject_v3(u2, j2, keys, indptr, filt, n, U, I, 17),
            filt,
            *native.relmf_prep_epoch(keys, indptr, filt, S, 1024, U, I, 6,
                                     64, 256, 16, 16, 1024, 3, 17),
            *native.cooccurrence(np.arange(500, dtype=np.int64) % 37,
                                 np.full(10, 50, np.int64), 37, 4)]
    h = hashlib.sha256()
    for a in outs:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()
"""


@pytest.mark.parametrize("omp", [1, 4])
def test_omp_num_threads_env(omp):
    """The library honours ``OMP_NUM_THREADS`` and gives the same bits at
    1 and 4 threads as at the default count (a fresh process: the OpenMP
    runtime reads the variable once)."""
    code = _DIGEST + "\nprint(native.num_threads(), digest())\n"
    env = dict(os.environ, OMP_NUM_THREADS=str(omp))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, digest = out.stdout.split()
    here = {}
    exec(_DIGEST, here)
    assert int(n) == omp and digest == here["digest"]()


# ---------------------------------------------------------------------------
# the prep functions built on them
# ---------------------------------------------------------------------------

def test_make_reject_filter(jn):
    _, _, keys = _problem(6)
    got = tpe.make_reject_filter(keys, U, I)
    want = jpe.make_reject_filter(keys, U, I)
    _equal([got[0], got[1], got[2], got[3]],
           [want[0], np.frombuffer(want[1], np.uint64), want[2], want[3]],
           ("keys", "filter", "indptr", "log2_bits"))
    assert tpe.make_reject_filter(np.empty(0, np.int64), U, I) is None


@pytest.mark.parametrize("filtered", [False, True])
def test_prep_epoch(jn, threads, filtered):
    u2, i2, keys = _problem(7)
    rh = pk.logical_rows(I, multiple=WROWS)
    kw = dict(native_seed=1234 * 1_000_003 + 2)
    got = tpe.prep_epoch(None, u2, i2, keys, U, I, K, rh, WROWS,
                         key_filter=tpe.make_reject_filter(keys, U, I)
                         if filtered else None, **kw)
    want = jpe.prep_epoch(None, u2, i2, keys, U, I, K, rh, WROWS,
                          key_filter=jpe.make_reject_filter(keys, U, I)
                          if filtered else None, **kw)
    _equal(got, want, PREP)
    assert got[1].dtype == np.uint8 and got[3].shape == (S, B // 128, 128)


def test_native_prep_equals_numpy_sides(jn, monkeypatch):
    """The native mask and j side equal the port's numpy rejection and
    sort applied to the native draws."""
    u2, i2, keys = _problem(8)
    rh = pk.logical_rows(I, multiple=WROWS)
    j2, mask, sj, rowsj, winj = tpe.prep_epoch(
        None, u2, i2, keys, U, I, K, rh, WROWS, native_seed=11,
        key_filter=tpe.make_reject_filter(keys, U, I))
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    _equal((mask, *tpe._sorted_side(j2, rh, WROWS, tpe.TILE)),
           (tpe._reject_mask(u2, j2, keys, U, I), sj, rowsj, winj),
           PREP[1:])


@pytest.mark.parametrize("filtered", [False, True])
def test_reject_mask(jn, monkeypatch, filtered):
    u2, _, keys = _problem(9)
    j2 = np.random.default_rng(9).integers(0, I, u2.shape).astype(np.int32)
    got = tpe._reject_mask(u2, j2, keys, U, I, key_filter=tpe.
                           make_reject_filter(keys, U, I) if filtered
                           else None)
    want = jpe._reject_mask(u2, j2, keys, U, I, key_filter=jpe.
                            make_reject_filter(keys, U, I) if filtered
                            else None)
    assert got.dtype == np.uint8 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    np.testing.assert_array_equal(got, tpe._reject_mask(u2, j2, keys, U, I))
    assert 0 < got.mean() < 1
    # no keys: only the in-data predicate applies
    monkeypatch.delenv("CYMF_TPU_PREP")
    np.testing.assert_array_equal(
        tpe._reject_mask(u2, j2, np.empty(0, np.int64), U, I), u2 < U)


@pytest.mark.parametrize("P", [128, 512])
def test_pool_prep_epoch(jn, P):
    u2, _, keys = _problem(10)
    got = tpe.prep_pool_epoch(np.random.default_rng((7, 2)), u2, keys, U, I,
                              P, key_filter=tpe.make_reject_filter(keys, U,
                                                                   I))
    want = jpe.prep_pool_epoch(np.random.default_rng((7, 2)), u2, keys, U, I,
                               P, key_filter=jpe.make_reject_filter(keys, U,
                                                                    I))
    _equal(got, want, ("pool2", "rjs", "mask", "j2"))


def test_prep_relmf_epoch(jn, threads):
    _, _, keys = _problem(11)
    Kr, wrows = 10, 16
    rw = pk.packed_rows(U, Kr, multiple=wrows)
    rh = pk.logical_rows(I, multiple=wrows)
    args = (7, 3, S, 1024, U, I, Kr, rw, rh, wrows, wrows, keys)
    got = tre.prep_relmf_epoch(
        *args, key_filter=tpe.make_reject_filter(keys, U, I))
    want = jre.prep_relmf_epoch(
        *args, key_filter=jpe.make_reject_filter(keys, U, I))
    _equal(got, want, RELMF)
    assert got[0].shape == (S, 1024) and got[5].shape == (S, 8, 128)


# ---------------------------------------------------------------------------
# checks and the backend switch
# ---------------------------------------------------------------------------

def test_validates_inputs_as_jax():
    """The malformed calls of tests/test_native_prep.py raise ValueError
    before the library runs."""
    u2, _, keys = _problem()
    rh = 256
    with pytest.raises(ValueError):  # u2 length != S*B
        native.bpr_prep_epoch_v2(u2[:, :-1].copy(), keys, S, B, U, I, 1, rh,
                                 128, 1024, 1)
    with pytest.raises(ValueError):  # I <= 0
        native.bpr_prep_epoch_v2(u2, keys, S, B, U, 0, 1, rh, 128, 1024, 1)
    with pytest.raises(ValueError):  # rh not a multiple of wrows
        native.bpr_prep_epoch_v2(u2, keys, S, B, U, I, 1, rh, 100, 1024, 1)
    with pytest.raises(ValueError):  # rh too small for the catalog
        native.bpr_prep_epoch_v2(u2, keys, S, B, U, I, 1, 128, 128, 1024, 1)
    with pytest.raises(ValueError):  # misaligned pos_keys bytes
        native.bpr_prep_epoch_v2(u2, keys.view(np.uint8)[:-4].copy(), S, B,
                                 U, I, 1, rh, 128, 1024, 1)
    j2 = np.zeros_like(u2)
    with pytest.raises(ValueError):  # u shorter than n
        native.pool_reject(u2[:, :100].copy(), j2, keys, u2.size, U, I)
    k, filt, indptr, lb = _filter_args(keys)
    with pytest.raises(ValueError):  # filter of another size
        native.pool_reject_v3(u2, j2, k, indptr, filt[:-1], u2.size, U, I,
                              lb)
    with pytest.raises(ValueError):  # indptr not spanning the keys
        native.pool_reject_v2(u2, j2, k, indptr[:-1], u2.size, U, I)
    bad = indptr.copy()
    bad[5] = bad[7] + 1
    for fn in (lambda: native.pool_reject_v2(u2, j2, k, bad, u2.size, U, I),
               lambda: native.relmf_prep_epoch(k, bad, filt, S, 1024, U, I,
                                               6, 64, 256, 16, 16, 1024, 3,
                                               lb)):
        with pytest.raises(ValueError, match="nondecreasing"):
            fn()
    with pytest.raises(OverflowError):  # a seed past int64, as JAX's "L"
        native.bpr_prep_epoch_v2(u2, keys, S, B, U, I, 1, rh, 128, 1024,
                                 2**63)
    neg = u2.copy()
    neg[0, 0] = -1
    with pytest.raises(ValueError, match="nondecreasing"):
        native.bpr_prep_epoch_v3(neg, k, indptr, filt, S, B, U, I, 1, rh,
                                 128, 1024, 1, lb)


def test_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not build makes ``prep_backend()`` and the fit
    raise with the compiler's output; ``CYMF_TPU_PREP=numpy`` still runs
    the numpy stream without it."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    X = SyntheticImplicitDataset(num_user=60, num_item=40, rank=3,
                                 density=0.2, seed=1).train
    with pytest.MonkeyPatch.context() as mp:    # the loaded library, after
        mp.setattr(native, "SOURCE", src)
        mp.setattr(native, "BUILD_DIR", tmp_path / "build")
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_error", None)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tpe.prep_backend()
        assert native.HAVE_NATIVE is False
        with pytest.raises(RuntimeError, match="broken.cpp"):
            ct.BPR(8, device="cpu").fit(X, num_epochs=1, verbose=False)
        monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
        m = ct.BPR(8, device="cpu")
        m.fit(X, num_epochs=1, verbose=False)
        assert tpe.prep_backend() == "numpy" and m.prep_backend_ == "numpy"


# ---------------------------------------------------------------------------
# trainers on the native stream, against the JAX fits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=300, num_item=200, rank=5,
                                    density=0.08, seed=11)


def _close_tables(mt, mj, opt, lr):
    for got, want in ((mt.W, mj.W), (mt.H, mj.H)):
        assert got.shape == want.shape and got.dtype == np.float32
        if opt == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        else:
            off = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
            assert off.mean() <= 0.01, off.mean()
            assert np.abs(got - want).max() <= 3 * lr
    np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=1e-3)


@pytest.mark.parametrize("k,opt,lr,pool,backend", [
    (20, "sgd", 0.05, 0, "native"),          # packed (v5 on this catalog)
    (20, "adam", 0.01, 0, "native"),
    (20, "sgd", 0.05, 128, "numpy"),         # pool: numpy draws
    (128, "sgd", 0.05, 0, "native"),         # wide
    (128, "adam", 0.01, 0, "native"),
])
def test_bpr_fit_matches_jax(jn, data, k, opt, lr, pool, backend):
    kw = dict(num_components=k, learning_rate=lr, optimizer=opt,
              weight_decay=0.01, neg_pool=pool)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        mj = cymf_tpu.BPR(packed="on", **kw)
        mj.fit(data.train, num_epochs=1, verbose=False, seed=5)
    mt = ct.BPR(device="cpu", **kw)
    mt.fit(data.train, num_epochs=1, verbose=False, seed=5)
    assert mj.prep_backend_ == mt.prep_backend_ == backend
    assert getattr(mj, "packed_kernel_", None) == \
        getattr(mt, "packed_kernel_", None)
    _close_tables(mt, mj, opt, lr)


@pytest.mark.parametrize("opt,lr", [("sgd", 0.05), ("adam", 0.01)])
def test_relmf_host_prep_fit_matches_jax(jn, data, monkeypatch, opt, lr):
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    kw = dict(num_components=10, learning_rate=lr, optimizer=opt,
              weight_decay=0.01, batch_size=4096)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        mj = cymf_tpu.RelMF(packed="on", **kw)
        mj.fit(data.train, num_epochs=1, verbose=False, seed=3)
    mt = ct.RelMF(device="cpu", **kw)
    mt.fit(data.train, num_epochs=1, verbose=False, seed=3)
    assert mj.prep_backend_ == mt.prep_backend_ == "native"
    assert set(mt.epoch_times_[0]) == {"prep_s", "device_s"}
    _close_tables(mt, mj, opt, lr)


# ---------------------------------------------------------------------------
# the overlap of each epoch's prep with the previous epoch
# ---------------------------------------------------------------------------

def _fit(model, X, overlap, **kw):
    model._overlap_prep = overlap        # the trainer's switch, on by default
    model.fit(X, verbose=False, seed=7, **kw)
    return model


@pytest.mark.parametrize("make,prep_env", [
    (lambda: ct.BPR(20, learning_rate=0.05, device="cpu"), "native"),
    (lambda: ct.BPR(20, learning_rate=0.05, device="cpu"), "numpy"),
    (lambda: ct.BPR(20, learning_rate=0.05, neg_pool=128, device="cpu"),
     "native"),
    (lambda: ct.BPR(128, learning_rate=0.05, device="cpu"), "native"),
    (lambda: ct.RelMF(10, learning_rate=0.05, batch_size=4096,
                      device="cpu"), "native"),
], ids=["packed", "packed-numpy", "pool", "wide", "relmf-host"])
def test_overlap_gives_the_same_tables(data, monkeypatch, make, prep_env):
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    if prep_env == "numpy":
        monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    fits = [_fit(make(), data.train, ov, num_epochs=3)
            for ov in (False, True)]
    for a, b in ((fits[0].W, fits[1].W), (fits[0].H, fits[1].H)):
        np.testing.assert_array_equal(a, b)
    assert fits[0].last_loss == fits[1].last_loss
    assert [set(t) for t in fits[1].epoch_times_] == \
        [{"prep_s", "device_s"}] * 3


class _Worsening:
    """A validator whose DCG@5 falls every epoch: early stopping ends the
    fit after 13 epochs and restores the first epoch's tables."""

    def __init__(self):
        self.calls = 0

    def evaluate(self, W, H):
        self.calls += 1
        return {"DCG@5": 1.0 / self.calls}


def test_overlap_drops_the_epoch_prepared_last(data):
    v = _Worsening()
    m = _fit(ct.BPR(20, learning_rate=0.05, device="cpu"), data.train, True,
             num_epochs=30, valid_evaluator=v, early_stopping=True)
    assert v.calls == len(m.epoch_times_) == 13
    one = _fit(ct.BPR(20, learning_rate=0.05, device="cpu"), data.train,
               False, num_epochs=1)
    np.testing.assert_array_equal(m.W, one.W)
    np.testing.assert_array_equal(m.H, one.H)


# ---------------------------------------------------------------------------
# the once-a-fit static streams: the library's counting sorts against the
# numpy bodies (CYMF_TPU_PREP=numpy), array for array
# ---------------------------------------------------------------------------

@pytest.fixture(params=[1, 8], ids=["omp1", "omp8"])
def static_threads(request):
    assert native.set_num_threads(request.param) == request.param
    return request.param


def _native_and_numpy(monkeypatch, fn):
    """``fn()`` on the native backend, then under ``CYMF_TPU_PREP=numpy``."""
    got = fn()
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    want = fn()
    monkeypatch.delenv("CYMF_TPU_PREP")
    return got, want


@pytest.mark.parametrize("multiple,batch,n", [
    (1024, 2048, 8192), (1024, 2048, 8000),  # counting sort; a padded tail
    (1, 100, 8000), (1, 96, 8000),           # U >= 16 B: the key sort
    (4, 1000, 8000), (4, 1002, 8000)])
def test_sorted_batches(static_threads, monkeypatch, multiple, batch, n):
    rng = np.random.default_rng(n + batch)
    users = rng.integers(0, 3000, n).astype(np.int32)
    users[:700] = 7                           # a long run of one user
    items = rng.integers(0, I, n).astype(np.int32)
    got, want = _native_and_numpy(monkeypatch, lambda: tbpr.sorted_batches(
        users, items, batch, multiple=multiple))
    _equal(got, want, ("u2", "i2"))
    assert got[0].shape[1] % multiple == 0
    assert (got[0] == tbpr.PAD_USER).any() == (got[0].size > n)


@pytest.mark.parametrize("case", ["plain", "beyond", "one_id"])
@pytest.mark.parametrize("Bs", [2048, 1152])
def test_sorted_side(static_threads, monkeypatch, case, Bs):
    """Ids at and past ``r_pad`` sort last, by id; a step of one repeated
    id; a step length that is not a tile multiple (windows re-anchored
    within its tile-rounded length)."""
    rng = np.random.default_rng(Bs)
    rh = 256
    v = rng.integers(0, I, (S, Bs)).astype(np.int32)
    if case == "beyond":
        v[0, ::7] = rh
        v[1, 3::5] = rh + rng.integers(0, 50, v[1, 3::5].size)
        v[2, -40:] = 2**31 - 1
    elif case == "one_id":
        v[1] = 17
    got, want = _native_and_numpy(
        monkeypatch, lambda: tpe._sorted_side(v, rh, WROWS, 1024))
    _equal(got, want, ("perm", "rows", "win"))


@pytest.mark.parametrize("Kp", [20, 40, 100])
def test_packed_windows(static_threads, monkeypatch, Kp):
    u2, _, _ = _problem(14)
    s = pk.num_slots(Kp)
    rw = pk.packed_rows(U, Kp, multiple=WROWS)
    got, want = _native_and_numpy(
        monkeypatch, lambda: tpe._packed_windows(u2, s, rw, WROWS, 1024))
    _equal([got], [want], ["winw"])


def _gated(Ug, K, wrows, seed=3):
    """Two steps of 1024 user-sorted samples over ``Ug`` users with a
    padded tail (tests/test_torch_packed_epoch.py's gate streams)."""
    rng = np.random.default_rng(seed)
    u2 = np.sort(rng.integers(0, Ug, (2, 1024)).astype(np.int32), axis=1)
    i2 = rng.integers(0, I, (2, 1024)).astype(np.int32)
    u2[-1, -100:] = tbpr.PAD_USER
    i2[-1, -100:] = 0
    return (u2, i2, pk.packed_rows(Ug, K, multiple=wrows),
            pk.logical_rows(I, multiple=wrows))


@pytest.mark.parametrize("Ug,K,wrows,force,want_v", [
    (12000, 20, 512, "4", 4), (12000, 20, 512, "", 4),
    (300, 20, 128, "", 5), (1200, 20, 512, "5", 5),
    (1200, 20, 512, "6", 6), (1200, 20, 512, "", 6),
    (12000, 20, 512, "7", 7), (12000, 31, 512, "7", 4)])
def test_prep_static(static_threads, monkeypatch, Ug, K, wrows, force,
                     want_v):
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", force)
    u2, i2, rw, rh = _gated(Ug, K, wrows)
    got, want = _native_and_numpy(monkeypatch, lambda: tpe.prep_static(
        u2, i2, K, rw, rh, wrows, wrows))
    assert got[-1] == want[-1] == want_v
    _equal(got[:-1], want[:-1],
           ("winw", "wstart", "si", "rowsi", "wini", "cs", "cn"))


@pytest.mark.parametrize("stride,margin", [(512, 16), (512, 64),
                                           (1024, 40), (1024, 512)])
def test_spans_fit(static_threads, stride, margin):
    """The span gate on dense, sparse and all-padding chunks."""
    for Ug in (300, 1200, 12000):
        u2, _, rw, _ = _gated(Ug, 20, 128)
        u2[0, :512] = tbpr.PAD_USER           # a chunk of padding alone
        s = pk.num_slots(20)
        pu2 = np.minimum(u2.astype(np.int64) // s, 2**31 - 1)
        assert native.spans_fit(u2, s, stride, margin, rw) == \
            tpe._spans_fit(pu2, stride, margin, rw)
    # a chunk whose rows span margin - 1 fits, one that spans margin not
    rw = 4 * margin
    for span_, fit in ((margin - 1, True), (margin, False)):
        u2 = np.zeros((2, 2048), np.int32)
        u2[1, :stride] = np.linspace(0, span_, stride).astype(np.int32)
        assert native.spans_fit(u2, 1, stride, margin, rw) == fit == \
            tpe._spans_fit(u2.astype(np.int64), stride, margin, rw)


@pytest.mark.parametrize("fn", ["pool", "wide", "shard", "shard_wide",
                                "shard_epoch", "glove"])
def test_static_preps(static_threads, monkeypatch, fn):
    """The engines' other static preps on both backends."""
    u2, i2, keys = _problem(15)
    K, n = 20, 2
    rw = pk.packed_rows(U, K, multiple=WROWS * n)
    rh = pk.logical_rows(I, multiple=WROWS)
    wr, wh = twe.wide_rows(U, 512 * n), twe.wide_rows(I, 512)
    calls = {
        "pool": lambda: tpe.prep_static_pool(u2, i2, K, rw, rh, WROWS,
                                             WROWS),
        "wide": lambda: twe.prep_static_wide(u2, i2, wr, wh, 512),
        "shard": lambda: tpe.prep_shard_static(u2, i2, K, rw, rh, WROWS,
                                               WROWS, n),
        "shard_wide": lambda: twe.prep_shard_static_wide(u2, i2, wr, wh,
                                                         512, n),
        "shard_epoch": lambda: tpe.prep_shard_epoch(
            i2[:, ::-1].copy(), (u2 < U).astype(np.uint8),
            *tpe.shard_slices(u2, K, rw, n), rh, WROWS, n),
        "glove": lambda: tge.prep_glove_static(
            u2, i2, np.full(u2.shape, 3.0), U, 10, pk.packed_rows(
                U, 12, multiple=WROWS), rh, WROWS, WROWS, 100.0, 0.75),
    }
    got, want = _native_and_numpy(monkeypatch, calls[fn])
    _equal(got, want, [f"{fn}[{k}]" for k in range(len(want))])


@pytest.mark.parametrize("filtered", [False, True])
def test_prep_epoch_j_side_is_the_static_sort(jn, static_threads,
                                              monkeypatch, filtered):
    """The per-epoch entries' j side, now the helper the static entry
    shares, is the JAX extension's bit for bit and equals the static
    entry and the numpy sort of the same draws."""
    u2, i2, keys = _problem(16)
    rh = pk.logical_rows(I, multiple=WROWS)
    kw = dict(native_seed=2**40 + 3)
    got = tpe.prep_epoch(None, u2, i2, keys, U, I, K, rh, WROWS,
                         key_filter=tpe.make_reject_filter(keys, U, I)
                         if filtered else None, **kw)
    want = jpe.prep_epoch(None, u2, i2, keys, U, I, K, rh, WROWS,
                          key_filter=jpe.make_reject_filter(keys, U, I)
                          if filtered else None, **kw)
    _equal(got, want, PREP)
    _equal(got[2:], native.sorted_side(got[0], rh, WROWS, tpe.TILE),
           PREP[2:])
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    _equal(got[2:], tpe._sorted_side(got[0], rh, WROWS, tpe.TILE), PREP[2:])


def test_static_entries_reject_bad_input():
    v = np.zeros((2, 256), np.int32)
    neg = v.copy()
    neg[1, 5] = -1
    first = v.copy()
    first[1, 0] = -2
    for fn in (lambda: native.sorted_side(neg, 256, 128, 1024),
               lambda: native.sorted_windows(first, 1, 256, 128, 1024),
               lambda: native.spans_fit(neg, 1, 128, 8, 256),
               lambda: native.sorted_side(neg.astype(np.int64), 256, 128,
                                          1024)):
        with pytest.raises(ValueError, match="negative|outside"):
            fn()
    for args in ((np.zeros((2, 200), np.int32), 256, 128, 1024),
                 (v, 250, 128, 1024),         # rows not a multiple of wrows
                 (v, 256, 128, 1000),         # tile not a multiple of 128
                 (v.ravel(), 256, 128, 1024),
                 (v.astype(np.float32), 256, 128, 1024)):
        with pytest.raises(ValueError):
            native.sorted_side(*args)
    with pytest.raises(ValueError, match="stride"):
        native.spans_fit(v, 1, 100, 8, 256)
    with pytest.raises(ValueError, match="slots"):
        native.sorted_windows(v, 0, 256, 128, 1024)
    users = np.arange(10, dtype=np.int32)
    for bad in (-1, 10):
        u = users.copy()
        u[3] = bad
        with pytest.raises(ValueError, match="outside"):
            native.sort_batches(u, users, 2, 8, 10, 2**31 - 1)
    with pytest.raises(ValueError):          # positives of another length
        native.sort_batches(users, users[:-1], 2, 8, 10, 2**31 - 1)
    with pytest.raises(ValueError):          # more samples than S * B
        native.sort_batches(users, users, 1, 8, 10, 2**31 - 1)
    u = users.copy()
    u[2] = -4
    with pytest.raises(ValueError, match="outside"):
        tbpr.sorted_batches(u, users, 4)


def test_mesh_caps_prep_threads_before_the_static_pass(monkeypatch, data):
    """On a mesh the library's threads are capped at the host's cores a
    local rank before ``sorted_batches`` runs."""
    class Stop(Exception):
        pass

    seen = []

    def batches(*args, **kwargs):
        seen.append(native.num_threads())
        raise Stop

    monkeypatch.setattr(tbpr, "sorted_batches", batches)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cores = os.cpu_count() or 1
    native.set_num_threads(cores)
    with use_torch_mesh(TorchMesh(None, 0, 2, torch.device("cpu"))):
        with pytest.raises(Stop):
            ct.BPR(20, device="cpu").fit(data.train, num_epochs=1,
                                         verbose=False)
    assert seen == [min(cores, max(1, cores // 2))]

