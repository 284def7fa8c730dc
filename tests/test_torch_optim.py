"""The port's row-sparse optimizers and index primitives against the JAX
package's (``cymf_tpu_torch.optim`` against ``cymf_tpu.optim``,
``cymf_tpu_torch.ops.segment`` against ``cymf_tpu.ops.segment``).

Tolerances: ``dedup_rows``, ``csr_contains`` and ``csr_lookup`` exact (the
same sorted order, the same sums in the same order); each optimizer's two
steps ``rtol 1e-6, atol 1e-7`` (``rsqrt``, ``sqrt`` and division may round
differently in the last place), and exactly: the rows the step must leave
alone (untouched, dropped, or hit by gradients that sum to zero) and
AdaGrad's accumulators of ones there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu import optim as joptim
from cymf_tpu.ops import segment as jseg
from cymf_tpu_torch import optim as toptim
from cymf_tpu_torch.ops import segment as tseg

PAD = 2**31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dedup_case(name):
    rng = np.random.default_rng(len(name))
    B = 64
    if name == "random":
        rows = rng.integers(0, 40, B)
    elif name == "duplicates":
        rows = rng.integers(0, 3, B)
    elif name == "drop_rows":        # the drop index and padding past it
        rows = rng.integers(0, 10, B)
        rows[::5] = 10
        rows[-7:] = PAD
    elif name == "one_row":
        rows = np.full(B, 4)
    else:                            # presorted, padding last
        rows = np.sort(rng.integers(0, 12, B))
        rows[-9:] = PAD
    grads = rng.standard_normal((B, 5)).astype(np.float32)
    return rows.astype(np.int32), grads


@pytest.mark.parametrize("width", [5, 1])
@pytest.mark.parametrize("case", ["random", "duplicates", "drop_rows",
                                  "one_row", "presorted"])
def test_dedup_rows_exact(case, width):
    rows, grads = _dedup_case(case)
    grads = grads[:, :width]
    presorted = case == "presorted"
    drop = 10 if case == "drop_rows" else 40
    jr, jg = jseg.dedup_rows(jnp.asarray(rows), jnp.asarray(grads), drop,
                             presorted=presorted)
    tr, tg = tseg.dedup_rows(_t(rows), _t(grads), drop, presorted=presorted)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tr.dtype == torch.int32 and tg.shape == grads.shape


def _csr(U, I, density, seed, empty_rows=()):
    from scipy import sparse
    X = sparse.random(U, I, density=density, random_state=seed, format="csr",
                      data_rvs=lambda n: np.arange(1, n + 1, dtype=float))
    X = X.tolil()
    for r in empty_rows:
        X[r, :] = 0
    X = X.tocsr()
    X.eliminate_zeros()
    X.sort_indices()
    return X


@pytest.mark.parametrize("shape,density,empty_rows", [
    ((30, 25), 0.2, (0, 7, 29)),     # empty rows, the last one included
    ((5, 300), 0.5, ()),             # long rows
    ((40, 3), 0.9, (3,)),            # nearly full
    ((6, 7), 0.0, ()),               # the empty matrix
])
def test_csr_contains_and_lookup_exact(shape, density, empty_rows):
    X = _csr(*shape, density, 1, empty_rows)
    U, I = shape
    rng = np.random.default_rng(2)
    seg = rng.integers(0, U, 500)
    query = rng.integers(0, I, 500)
    coo = X.tocoo()                  # every stored cell queried too
    seg = np.concatenate([seg, coo.row]).astype(np.int32)
    query = np.concatenate([query, coo.col]).astype(np.int32)
    indptr = X.indptr.astype(np.int32)
    indices = X.indices.astype(np.int32)
    data = X.data.astype(np.float32)
    jc = jseg.csr_contains(jnp.asarray(indptr), jnp.asarray(indices),
                           jnp.asarray(seg), jnp.asarray(query))
    jf, jv = jseg.csr_lookup(jnp.asarray(indptr), jnp.asarray(indices),
                             jnp.asarray(data), jnp.asarray(seg),
                             jnp.asarray(query))
    tc = tseg.csr_contains(_t(indptr), _t(indices), _t(seg), _t(query))
    tf, tv = tseg.csr_lookup(_t(indptr), _t(indices), _t(data), _t(seg),
                             _t(query))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.asarray(X[seg, query]).ravel()
    np.testing.assert_array_equal(tv.numpy(), want.astype(np.float32))
    assert tc.sum() == (want != 0).sum() >= X.nnz


R, K = 12, 4


def _steps(seed):
    """Two steps of (rows, grads): duplicates, rows past the table (the
    drop index, past it and the padding id), row 5 hit by gradients that
    sum to exactly zero, row 6 only by masked (signed-zero) gradients;
    rows 9-11 never."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        rows = np.concatenate([rng.integers(0, 5, 20), [7, 7, 8],
                               [R, R + 3, PAD], [5, 5], [6, 6]])
        grads = rng.standard_normal((len(rows), K)).astype(np.float32)
        grads[-4] = rng.standard_normal(K).astype(np.float32)
        grads[-3] = -grads[-4]
        grads[-2:] = -0.0 * np.abs(grads[-2:])
        perm = rng.permutation(len(rows))
        out.append((rows[perm].astype(np.int32), grads[perm]))
    return out


def _run(name, lr, mode, pkg):
    rng = np.random.default_rng(7)
    table0 = rng.standard_normal((R, K)).astype(np.float32)
    steps = _steps(3)
    if pkg == "jax":
        opt = joptim.make_optimizer(name, lr)
        table = jnp.asarray(table0)
        state = opt.init(table)
        put = jnp.asarray
    else:
        opt = toptim.make_optimizer(name, lr)
        table = _t(table0.copy())
        state = opt.init(table)
        put = _t
    for t, (rows, grads) in enumerate(steps):
        if mode == "rows":
            table, state = opt.update_rows(table, state, put(rows),
                                           put(grads))
        else:  # one pair, then the step split into two pairs
            cut = len(rows) if t == 0 else len(rows) // 2
            pairs = [(put(rows[a:b]), put(grads[a:b]))
                     for a, b in ((0, cut), (cut, len(rows))) if b > a]
            table, state = opt.update_dense(table, state, pairs)
    return table0, np.asarray(table), {k: np.asarray(v)
                                       for k, v in state.items()}


@pytest.mark.parametrize("mode", ["rows", "dense"])
@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("adagrad", 0.1),
                                     ("adam", 0.01)])
def test_optimizer_two_steps_match_jax(name, lr, mode):
    table0, jt, js = _run(name, lr, mode, "jax")
    _, tt, ts = _run(name, lr, mode, "torch")
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-7)
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, atol=1e-7)
    # untouched rows 9-11 and masked-only row 6 stay the same bits; so does
    # the zero-sum row 5 under Adam (touched iff its summed gradient is not
    # exactly zero) and, with a zero update, under sgd and adagrad
    still = [5, 6, 9, 10, 11]
    np.testing.assert_array_equal(tt[still], table0[still])
    np.testing.assert_array_equal(tt[still], jt[still])
    if name == "adagrad":
        np.testing.assert_array_equal(ts["accum"][still], 1.0)
        assert (ts["accum"][:5] > 1).all()
    if name == "adam":
        for k in ("m", "v"):
            np.testing.assert_array_equal(ts[k][still], 0.0)
            assert (ts[k][:5] != 0).any(axis=1).all()
    assert not np.array_equal(tt[:5], table0[:5])


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_rows_sorted_is_only_a_hint(name):
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, R, 50)).astype(np.int32)
    grads = _t(rng.standard_normal((50, K)).astype(np.float32))
    out = []
    for hint in (False, True):
        opt = toptim.make_optimizer(name, 0.05)
        table = _t(np.ones((R, K), np.float32))
        state = opt.init(table)
        opt.update_dense(table, state, [(_t(rows), grads)], rows_sorted=hint)
        out.append(table.numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_make_optimizer_whitelist_and_exports():
    for name, cls in (("sgd", toptim.Sgd), ("adagrad", toptim.AdaGrad),
                      ("adam", toptim.Adam)):
        assert isinstance(toptim.make_optimizer(name, 0.1), cls)
    with pytest.raises(Exception) as te:
        toptim.make_optimizer("rmsprop", 0.1)
    with pytest.raises(Exception) as je:
        joptim.make_optimizer("rmsprop", 0.1)
    assert str(te.value) == str(je.value) == "rmsprop is invalid."
    assert ct.optim is toptim and "optim" in ct.__all__
    assert cymf_tpu.optim is joptim
    names = ("SparseOptimizer", "Sgd", "AdaGrad", "Adam", "make_optimizer")
    for n in names:
        assert hasattr(joptim, n) and hasattr(toptim, n), n
    assert issubclass(toptim.Adam, toptim.SparseOptimizer)
    adam = toptim.Adam()
    assert (adam.alpha, adam.beta1, adam.beta2, adam.epsilon) == \
        (0.001, 0.9, 0.999, 1e-8)
