"""Synthetic implicit-feedback data for tests and benchmarks.

The same generators as `cymf_tpu/dataset/synthetic.py`, without
scikit-learn: the train/valid/test split replays
``sklearn.model_selection.train_test_split(idx, test_size=0.1,
random_state=12345)`` with numpy (:func:`~.implicit.holdout_split`, the
file-backed loaders' split too), so both packages split the same
interactions the same way.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import sparse

from .implicit import ImplicitFeedbackDataset, holdout_split


def synthetic_interactions(num_user: int, num_item: int, rank: int = 8,
                           density: float = 0.05, seed: int = 0,
                           noise: float = 0.2) -> sparse.csr_matrix:
    """Binary interaction matrix sampled from a planted low-rank model.

    Scores S = U V^T + noise; the top ``density * num_user * num_item`` cells
    become positives.  Guarantees every user has at least one interaction.
    """
    rng = np.random.default_rng(seed)
    Uf = rng.normal(size=(num_user, rank)) / np.sqrt(rank)
    Vf = rng.normal(size=(num_item, rank)) / np.sqrt(rank)
    scores = Uf @ Vf.T + noise * rng.normal(size=(num_user, num_item))
    nnz = max(int(density * num_user * num_item), num_user)
    thresh = np.partition(scores.ravel(), -nnz)[-nnz]
    X = (scores >= thresh).astype(np.float64)
    # ensure no empty users (the reference datasets have none either)
    empty = X.sum(axis=1) == 0
    X[empty, np.argmax(scores[empty], axis=1)] = 1.0
    return sparse.csr_matrix(X)


class SyntheticImplicitDataset(ImplicitFeedbackDataset):
    """Train/valid/test splits over synthetic interactions, with the same
    90/10/10 protocol as the MovieLens loader (`movielens.py:65-66`)."""

    def __init__(self, num_user: int = 200, num_item: int = 100,
                 rank: int = 8, density: float = 0.05, seed: int = 0):
        self.num_user = num_user
        self.num_item = num_item
        X = synthetic_interactions(num_user, num_item, rank, density, seed)
        coo = X.tocoo()
        idx = np.arange(coo.nnz)
        tr, te = holdout_split(idx)
        tr, va = holdout_split(tr)

        def to_lil(sel):
            m = sparse.coo_matrix(
                (coo.data[sel], (coo.row[sel], coo.col[sel])),
                shape=(num_user, num_item))
            return m.tolil()

        self.train = to_lil(tr)
        self.valid = to_lil(va)
        self.test = to_lil(te)
        self._finalize()


def bench_interactions(num_user: int, num_item: int, nnz: int,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(users, items) interaction arrays with an ML-20M-like user degree
    profile, for throughput benchmarks (no low-rank structure needed to
    measure interactions/sec).

    Degrees follow a rank-frequency power law CAPPED at ~35% of the
    catalog (real ML-20M's top user rated 9,254 of 26,744 movies); a
    user's items are near-distinct (heavy users sample without
    replacement), so rejection masks run at realistic (~0.5%) collision
    rates.  The round-2 generator (``zipf(1.3) % num_user``) put 25% of
    all interactions on ONE user with degree 5M >> catalog size — its
    sorted streams had giant single-row runs and ~77% of negative draws
    were rejection-masked, neither of which real data exhibits."""
    rng = np.random.default_rng(seed)
    # ~35% of the catalog, relaxed to the minimum feasible (uniform)
    # level for dense small configs, never beyond the catalog itself
    cap = min(num_item, max(int(num_item * 0.35), -(-nnz // num_user), 1))
    if nnz > num_user * cap:
        raise ValueError(
            f"nnz={nnz} exceeds num_user*num_item — impossible for "
            "distinct-leaning interactions")
    ranks = np.arange(1, num_user + 1, dtype=np.float64)
    w = ranks ** -0.8
    degf = w * (nnz / w.sum())
    # shape-preserving cap: move clipped mass onto the uncapped tail
    # proportionally, iterating until no user exceeds the cap (keeps the
    # power-law shape below the cap instead of flattening the tail)
    for _ in range(200):
        over = degf > cap
        spare = float((degf[over] - cap).sum())
        degf[over] = cap
        tail = ~over
        if spare <= 1e-9 or not tail.any():
            break
        degf[tail] *= 1.0 + spare / float(degf[tail].sum())
    degf = np.minimum(degf, cap)
    deg = np.floor(degf).astype(np.int64)
    # exact conservation: +1 to the largest fractional remainders (room
    # permitting — the capacity check above guarantees enough room), then
    # a waterfill fallback for any pathological leftover
    deficit = nnz - int(deg.sum())
    if deficit > 0:
        order = np.argsort(-(degf - deg), kind="stable")
        takeable = order[(cap - deg)[order] >= 1]
        deg[takeable[:deficit]] += 1
        deficit = nnz - int(deg.sum())
        if deficit > 0:
            room = cap - deg
            idx = np.argsort(-room, kind="stable")
            prior = np.concatenate([[0], np.cumsum(room[idx])[:-1]])
            deg[idx] += np.clip(deficit - prior, 0, room[idx])
    assert int(deg.sum()) == nnz, (deg.sum(), nnz)
    users = np.repeat(np.arange(num_user, dtype=np.int32), deg)
    items = np.empty(nnz, np.int32)
    # near-distinct per-user items: permutation slices for heavy users,
    # with-replacement draws elsewhere (dup rate < 4% at deg <= cap/4)
    heavy = np.flatnonzero(deg > num_item // 4)
    starts = np.concatenate([[0], np.cumsum(deg)])
    mask = np.ones(nnz, bool)
    for u in heavy:
        d = int(deg[u])
        items[starts[u]:starts[u] + d] = rng.permutation(
            num_item).astype(np.int32)[:d]
        mask[starts[u]:starts[u + 1]] = False
    items[mask] = rng.integers(0, num_item, size=int(mask.sum()),
                               dtype=np.int32)
    perm = rng.permutation(nnz)
    return users[perm], items[perm]
