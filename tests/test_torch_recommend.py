"""The port's full-catalog ``recommend`` against ``cymf_tpu.recommend``.

The cases of ``tests/test_recommend.py`` on the same numpy inputs: the
items equal JAX's, the scores within ``rtol 1e-5``.  ``jax.lax.top_k``
breaks ties by ascending item id and ``torch.topk`` promises no order, so
a tie-heavy case (integer factors; users whose exclusions leave fewer than
k finite scores) must give JAX's items exactly.  The JAX side runs on one
device (``conftest.py`` fakes 8, which would take its sharded path).
"""

import jax
import numpy as np
import pytest
from scipy import sparse

import cymf_tpu
import cymf_tpu_torch as ct
from cymf_tpu.parallel import MeshContext, use_mesh


@pytest.fixture(autouse=True)
def one_device():
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield


def _both(W, H, **kw):
    sj, ij = cymf_tpu.recommend(W, H, **kw)
    st, it = ct.recommend(W, H, device="cpu", **kw)
    assert st.dtype == np.float32 and it.dtype == np.int32
    assert st.shape == sj.shape and it.shape == ij.shape
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    return st, it


def test_recommend_orders_by_score():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(20, 6))
    H = rng.normal(size=(40, 6))
    scores, items = _both(W, H, k=5)
    full = W @ H.T
    for u in range(20):
        want = np.argsort(-full[u])[:5]
        np.testing.assert_array_equal(items[u], want)
        np.testing.assert_allclose(scores[u], full[u][want], rtol=1e-5)


def test_recommend_excludes_train_positives():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(10, 4))
    H = rng.normal(size=(15, 4))
    X = sparse.random(10, 15, density=0.3, random_state=1, format="csr",
                      data_rvs=lambda n: np.ones(n))
    _, items = _both(W, H, k=5, exclude=X)
    for u in range(10):
        assert not (set(items[u].tolist()) & set(X[u].indices))


def test_recommend_chunking_consistent():
    rng = np.random.default_rng(2)
    W = rng.normal(size=(33, 5))
    H = rng.normal(size=(21, 5))
    s1, i1 = _both(W, H, k=3, user_chunk=7)
    s2, i2 = _both(W, H, k=3, user_chunk=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def test_recommend_k_too_large():
    with pytest.raises(ValueError, match="catalog"):
        ct.recommend(np.ones((3, 2)), np.ones((4, 2)), k=10, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recommend_ties_by_ascending_item_id(seed):
    """Integer factors in [-2, 2] (zero products included) make most
    scores tie; user 3 has I - 3 exclusions and user 7 all items but
    k - 2 (fewer than k finite scores: the rest tie at -inf); users 11
    to 13 have no exclusion, and the chunks of 16 users cut the rows
    mid-catalog."""
    rng = np.random.default_rng(seed)
    U, I, K, k = 50, 40, 3, 8
    W = rng.integers(-2, 3, (U, K)).astype(np.float32)
    H = rng.integers(-2, 3, (I, K)).astype(np.float32)
    X = sparse.random(U, I, density=0.3, random_state=seed,
                      format="lil")
    X[3, :I - 3] = 1
    X[7, :] = 0
    X[7, :I - k + 2] = 1
    X[11:14, :] = 0
    X = X.tocsr()
    X.data[:] = 1.0
    scores, items = _both(W, H, k=k, exclude=X, user_chunk=16)
    full = W @ H.T
    for u in range(U):
        row = np.where(X[u].toarray()[0] > 0, -np.inf, full[u])
        want = np.lexsort((np.arange(I), -row))[:k]
        np.testing.assert_array_equal(items[u], want)
        np.testing.assert_array_equal(scores[u], row[want])


def test_recommend_takes_tensors_and_exports():
    import torch
    assert ct.evaluator.recommend is ct.recommend
    assert "recommend" in ct.__all__
    rng = np.random.default_rng(3)
    W, H = rng.normal(size=(12, 4)), rng.normal(size=(30, 4))
    s1, i1 = ct.recommend(torch.tensor(W), torch.tensor(H), k=4,
                          device="cpu")
    s2, i2 = ct.recommend(W, H, k=4, device="cpu")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
