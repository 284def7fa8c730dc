"""The port's evaluator pieces against the JAX package's.

The hash set must be built identically and answer identically; the
top-k metric forms must agree to float32 round-off (``rtol 1e-6``).  The
negatives are drawn by different generators (torch vs threefry), so the
chunk scorer is compared on the JAX draws: fed the negatives of JAX
``draw_negatives(..., key)``, it must match JAX ``_chunk_metric_sums(...,
key)`` to ``rtol 1e-5`` on tie-free random tables (the score contraction
reduces in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from cymf_tpu.evaluation import evaluator as jev
from cymf_tpu.evaluation import metrics as jm
from cymf_tpu.ops import hashset as jhs
from cymf_tpu_torch.evaluation import evaluator as tev
from cymf_tpu_torch.evaluation import metrics as tm
from cymf_tpu_torch.ops import hashset as ths


def _pairs(seed=0, U=3000, I=300, n=20000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, U, n), rng.integers(0, I, n)


def test_build_pair_hashset_identical():
    u, i = _pairs()
    got = ths.build_pair_hashset(u, i)
    want = jhs.build_pair_hashset(u, i)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_hashset_contains_matches_jax():
    u, i = _pairs(1)
    rng = np.random.default_rng(2)
    qu = np.concatenate([u[:5000], rng.integers(0, 3000, 5000)])
    qi = np.concatenate([i[:5000], rng.integers(0, 300, 5000)])
    want = np.asarray(jhs.hashset_contains(
        jhs.build_pair_hashset(u, i), jnp.asarray(qu, jnp.int32),
        jnp.asarray(qi, jnp.int32)))
    hs = ths.to_device(ths.build_pair_hashset(u, i), "cpu")
    got = ths.hashset_contains(hs, torch.from_numpy(qu.astype(np.int32)),
                               torch.from_numpy(qi.astype(np.int32)))
    assert want[:5000].all() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 5, 10])
def test_topk_metric_forms_match_jax(k):
    rng = np.random.default_rng(k)
    C, L = 64, 10
    labels = (rng.random((C, L)) < 0.3).astype(np.float32)
    labels[:4] = 0.0                                  # users with no hit
    props = rng.uniform(1e-4, 1.0, (C, L)).astype(np.float32)
    total = (labels.sum(1) + rng.integers(0, 3, C)).astype(np.float32)
    total[:2] = 0.0                                   # no positives at all
    sn = (labels / props).sum(1).astype(np.float32)
    t = {n: torch.from_numpy(a) for n, a in
         dict(labels=labels, props=props, total=total, sn=sn).items()}
    for name in ("dcg", "recall", "average_precision"):
        want = getattr(jm, f"{name}_topk_batch")(
            jnp.asarray(labels), jnp.asarray(total), k)
        got = getattr(tm, f"{name}_topk_batch")(t["labels"], t["total"], k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        want = getattr(jm, f"{name}_with_ips_topk_batch")(
            jnp.asarray(labels), jnp.asarray(props), jnp.asarray(sn), k)
        got = getattr(tm, f"{name}_with_ips_topk_batch")(
            t["labels"], t["props"], t["sn"], k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _split_data(seed=3, U=400, I=250):
    rng = np.random.default_rng(seed)
    dense = rng.random((U, I))
    test = sparse.csr_matrix((dense < 0.04).astype(float))
    train = sparse.csr_matrix(((dense >= 0.04) & (dense < 0.12))
                              .astype(float))
    return test, train


@pytest.mark.parametrize("unbiased", [False, True])
def test_chunk_scorer_matches_jax_on_jax_negatives(unbiased):
    test, train = _split_data()
    U, I = test.shape
    rng = np.random.default_rng(4)
    W = rng.normal(size=(U, 8)).astype(np.float32)   # continuous: no ties
    H = rng.normal(size=(I, 8)).astype(np.float32)
    je = jev.Evaluator(test, train, k=[1, 3, 5], num_negatives=30,
                       unbiased=unbiased)
    te = tev.Evaluator(test, train, k=[1, 3, 5], num_negatives=30,
                       unbiased=unbiased, device="cpu")
    ks, names = (1, 3, 5), ("DCG", "Recall", "MAP")
    up = te.user_positives.tocoo()
    jhs_ = jhs.build_pair_hashset(up.row, up.col)
    props = te.propensity_scores.astype(np.float32)
    assert len(te._user_chunks) == len(je._user_chunks)
    for ci, ((uids, pos, val), jc) in enumerate(zip(te._user_chunks,
                                                    je._user_chunks)):
        for a, b in zip((uids, pos, val), jc):
            np.testing.assert_array_equal(a, b)
        key = jax.random.fold_in(jax.random.PRNGKey(7), ci)
        want = np.asarray(jev._chunk_metric_sums(
            jnp.asarray(W), jnp.asarray(H), jnp.asarray(uids),
            jnp.asarray(pos), jnp.asarray(val), jhs_, jnp.asarray(props),
            key, num_negatives=30, ks=ks, metric_names=names,
            unbiased=unbiased))
        neg, nvalid = jev.draw_negatives(jnp.asarray(uids), jhs_, key, I, 30,
                                         dtype=jnp.int32)
        got = tev._chunk_metric_sums(
            torch.from_numpy(W), torch.from_numpy(H),
            torch.from_numpy(uids), torch.from_numpy(pos),
            torch.from_numpy(val), torch.from_numpy(np.array(neg)),
            torch.from_numpy(np.array(nvalid)), torch.from_numpy(props),
            ks=ks, metric_names=names, unbiased=unbiased)
        assert want.sum() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_draw_negatives_exact_count_on_dense_matrix():
    """Rejection refills until every user has exactly num_negatives
    non-positive items (`evaluator.pyx:106-111`), even at 90% density."""
    U, I = 8, 200
    dense = np.random.default_rng(0).random((U, I)) < 0.9
    X = sparse.csr_matrix(dense.astype(float))
    coo = X.tocoo()
    hs = ths.to_device(ths.build_pair_hashset(coo.row, coo.col), "cpu")
    gen = torch.Generator().manual_seed(0)
    neg, valid = tev.draw_negatives(torch.arange(U, dtype=torch.int32), hs,
                                    gen, I, 100)
    assert valid.all()
    for u in range(U):
        assert not dense[u, neg[u].numpy()].any()


def test_evaluate_is_deterministic_and_ranks_perfect_model_first():
    test, train = _split_data(5, U=60, I=80)
    ev = tev.AoaEvaluator(test, train, k=[5, 80], num_negatives=20,
                          device="cpu")
    # score(u, i) = 1 on u's test positives, 0 elsewhere: every positive
    # ranks above every sampled negative
    W = test.toarray().astype(np.float32)
    H = np.eye(80, dtype=np.float32)
    res = ev.evaluate(W, H)
    assert res == ev.evaluate(W, H)               # same seed, same draws
    assert set(res) == {f"{m}@{k}" for m in ("DCG", "Recall", "MAP")
                        for k in (5, 80)}
    P = np.diff(test.indptr)
    want = np.where(P > 0, np.minimum(P, 5) / np.maximum(P, 1), 0).mean()
    assert res["Recall@5"] == pytest.approx(want, rel=1e-6)
    assert res["Recall@80"] == pytest.approx((P > 0).mean(), rel=1e-6)
    ub = tev.UnbiasedEvaluator(test, train, k=5, num_negatives=20,
                               device="cpu").evaluate(W, H)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in ub.values())
