"""The port's ALS primitives (``ops/als.py``) against the JAX package's.

``build_chunks`` must give the very same arrays (it is host numpy, ported
line for line).  The chunk solves take the same ``Y``, ``A0`` and chunk on
both sides and agree to ``5e-4`` relative to the largest entry, the JAX
package's bound for its own blocked solve (`tests/test_wmf.py`).  The JAX
side runs on one device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from cymf_tpu.ops import als as jals
from cymf_tpu_torch.ops import als


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test, restored after, as the other files that
    pin it do.  A batched LU solve at K > 128 with several threads hangs
    in a process whose torch thread count was set to 1 and back before
    (MKL's SLASWP is then called with a bad argument), which another
    file's test in the same worker may have done; one thread solves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed():
    rows = np.concatenate([np.zeros(500, int), np.arange(1, 50),
                           np.repeat(np.arange(50, 80), 7)])
    cols = np.concatenate([np.arange(500) % 600, np.zeros(49, int),
                           np.arange(210) * 3 % 600])
    X = sparse.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(90, 600))
    X.sort_indices()
    return X


@pytest.mark.parametrize("X,kw", [
    (_skewed(), dict(chunk_size=64, drop_sentinel=90)),
    (_skewed(), dict(chunk_size=64, drop_sentinel=90, max_elems=1024)),
    (_skewed().T.tocsr(), dict(chunk_size=16, drop_sentinel=600)),
    (sparse.csr_matrix((4, 6)), dict(chunk_size=8, drop_sentinel=9)),
    (sparse.csr_matrix(np.ones((1, 5))), dict(chunk_size=8,
                                              drop_sentinel=3)),
    (sparse.random(700, 300, density=0.05, random_state=3, format="csr"),
     dict(chunk_size=2048, drop_sentinel=700, num_components=256)),
    (sparse.random(700, 300, density=0.05, random_state=3, format="csr"),
     dict(chunk_size=2048, drop_sentinel=700, max_elems=1 << 12,
          num_components=1 << 14)),
])
def test_build_chunks_identical(X, kw):
    X.sort_indices()
    got, want = als.build_chunks(X, **kw), jals.build_chunks(X, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_place_device_chunks_drops_sentinels():
    ch = als.AlsChunk(np.array([3, 0, 5], np.int32),
                      np.array([[1, 2], [0, 0], [0, 0]], np.int32),
                      np.array([[1, 1], [1, 0], [0, 0]], bool),
                      np.ones((3, 2), np.float32))
    (d,) = als.place_device_chunks([ch], "cpu", num_rows=5)
    assert d.rows.dtype == torch.int64 and d.rows.tolist() == [3, 0]
    assert d.idx_pad.tolist() == [[1, 2], [0, 0]]
    assert d.valid.tolist() == [[True, True], [True, False]]


def _inputs(K, rng, n_other=150, C=24, P=32):
    Y = (rng.standard_normal((n_other, K)) / np.sqrt(K)).astype(np.float32)
    A0 = (Y.T @ Y + 0.05 * np.eye(K)).astype(np.float32)
    deg = rng.integers(0, P + 1, C)
    deg[3] = 0                                   # an empty row
    idx = np.zeros((C, P), np.int32)
    valid = np.arange(P)[None, :] < deg[:, None]
    for c in range(C):
        idx[c, :deg[c]] = rng.choice(n_other, deg[c], replace=False)
    return Y, A0, idx, valid


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("form", ["standard", "woodbury"])
def test_chunk_solves_match_jax(K, form):
    Y, A0, idx, valid = _inputs(K, np.random.default_rng(K))
    if form == "woodbury":
        A0 = np.linalg.inv(A0.astype(np.float64)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (Y, A0, idx, valid)]
    j = [jnp.asarray(a) for a in (Y, A0, idx, valid)]
    jfn, fn = ((jals.wmf_chunk_solve, als.wmf_chunk_solve)
               if form == "standard" else
               (jals.wmf_chunk_solve_woodbury,
                als.wmf_chunk_solve_woodbury))
    for jname, name in (("cholesky_blocked64", "cholesky_blocked64"),
                        ("cholesky_blocked64", "cholesky_cuda64"),
                        ("cholesky_xla", "cholesky_xla"), ("lu", "lu")):
        want = np.array(jfn(*j, 10.0, solver=jname))
        got = fn(*t, 10.0, solver=name).numpy()
        assert _rel(got, want) <= 5e-4, (name, _rel(got, want))
        assert (got[3] == 0).all()


@pytest.mark.parametrize("K,block", [(128, 64), (256, 64), (256, 32),
                                     (192, 64)])
def test_blocked_solve_matches_jax(K, block):
    rng = np.random.default_rng(K + block)
    X = rng.standard_normal((5, K, K)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + np.eye(K, dtype=np.float32)
    b = rng.standard_normal((5, K)).astype(np.float32)
    want = np.array(jals._solve_spd_blocked(jnp.asarray(A), jnp.asarray(b),
                                            block))
    for diag in ("plain", "kernel"):
        got = als._solve_spd_blocked(torch.from_numpy(A),
                                     torch.from_numpy(b), block,
                                     diag).numpy()
        assert _rel(got, want) < 5e-4, (diag, _rel(got, want))


@pytest.mark.parametrize("K", [16, 128, 256])
def test_solve_spd_routes_and_matches_jax(monkeypatch, K):
    """The eager ``solve_spd`` routes by width as ``resolve_chol_solver``
    does (dense below 128, the blocked form at 128 and above on the CPU)
    and solves as JAX's ``solve_spd``; a bfloat16 right-hand side is
    promoted to float32, as JAX promotes it."""
    for v in ("CYMF_TPU_ALS_CHOL", "CYMF_TPU_ALS_CHOL_BLOCK"):
        monkeypatch.delenv(v, raising=False)
    rng = np.random.default_rng(K)
    X = rng.standard_normal((3, K, K)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + np.eye(K, dtype=np.float32)
    b = rng.standard_normal((3, K)).astype(np.float32)
    want = np.array(jals.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    got = als.solve_spd(torch.from_numpy(A), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 5e-4
    bb = torch.from_numpy(b).to(torch.bfloat16)
    got = als.solve_spd(torch.from_numpy(A), bb).numpy()
    want = np.array(jals.solve_spd(jnp.asarray(A), jnp.asarray(
        bb.float().numpy(), jnp.bfloat16)))
    assert _rel(got, want) < 5e-4
