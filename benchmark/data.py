"""Inputs of every cell, made from ``--seed``: frozen copies, numpy only.

``bench_interactions`` and ``holdout_split`` are copies of the port's
``dataset/synthetic.py::bench_interactions`` and
``dataset/implicit.py::holdout_split`` as they stood when this benchmark
was written, so that a later change to the program cannot move the
traffic.  Tables are drawn on the run's device with a ``torch.Generator``
in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import sparse


def sub_seed(seed: int, *tags: int) -> int:
    """A 31-bit seed derived from the run's ``--seed`` (any whole number)
    and ``tags``: every stream a run draws has its own."""
    ss = np.random.SeedSequence([seed % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def bench_interactions(num_user: int, num_item: int, nnz: int,
                       seed: int = 0):
    """(users, items) int32 arrays of ``nnz`` draws: users' degrees a
    rank-frequency power law (exponent 0.8) capped at 35% of the catalog,
    heavy users' items drawn without replacement, the rest uniform with
    replacement (every item equally likely), then shuffled."""
    rng = np.random.default_rng(seed)
    cap = min(num_item, max(int(num_item * 0.35), -(-nnz // num_user), 1))
    if nnz > num_user * cap:
        raise ValueError(f"nnz={nnz} exceeds num_user*num_item")
    ranks = np.arange(1, num_user + 1, dtype=np.float64)
    w = ranks ** -0.8
    degf = w * (nnz / w.sum())
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
    if int(deg.sum()) != nnz:
        raise ValueError("degree profile does not conserve nnz")
    users = np.repeat(np.arange(num_user, dtype=np.int32), deg)
    items = np.empty(nnz, np.int32)
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


def holdout_split(idx: np.ndarray, test_size: float = 0.1,
                  seed: int = 12345):
    """``(train, test)`` as scikit-learn's ``train_test_split`` draws them:
    one ``RandomState(seed)`` permutation, the first ``ceil(test_size *
    n)`` positions are the test part."""
    n = len(idx)
    n_test = math.ceil(test_size * n)
    p = np.random.RandomState(seed).permutation(n)
    return idx[p[n_test:]], idx[p[:n_test]]


def interactions(cfg: dict, seed: int) -> sparse.csr_matrix:
    """The configuration's binary interaction matrix for ``seed``
    (duplicate draws merged), sorted indices."""
    U, I = cfg["num_user"], cfg["num_item"]
    users, items = bench_interactions(U, I, cfg["draws"],
                                      seed=sub_seed(seed, 1))
    X = sparse.csr_matrix((np.ones(len(users), np.float32), (users, items)),
                          shape=(U, I))
    X.sum_duplicates()
    X.data[:] = 1.0
    return X


def train_valid(X: sparse.csr_matrix):
    """``(train, valid)`` as the repo's loaders split: 10% test held out,
    then 10% of the rest as validation (``holdout_split`` twice)."""
    coo = X.tocoo()
    tr, _ = holdout_split(np.arange(coo.nnz))
    tr, va = holdout_split(tr)

    def part(sel):
        m = sparse.csr_matrix(
            (coo.data[sel], (coo.row[sel], coo.col[sel])), shape=X.shape)
        m.sort_indices()
        return m

    return part(tr), part(va)


def uniform_tables(U: int, I: int, K: int, seed: int, device):
    """``(W, H)`` float32 on ``device``, U(-0.1, 0.1) / K: the trainers'
    own initial distribution, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = torch.rand((U, K), generator=gen, device=device) * 0.2 - 0.1
    H = torch.rand((I, K), generator=gen, device=device) * 0.2 - 0.1
    return W / K, H / K
