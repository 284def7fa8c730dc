"""AoA DCG@k over sampled candidates, worked out again in plain PyTorch.

The evaluator's documented protocol (``evaluation/evaluator.py``, the
reference's ``evaluator.pyx``): users in chunks of ascending test degree
(each chunk padded to a power of two with users that add 0), per user
its test positives plus exactly ``num_negatives`` negatives drawn
uniformly from a ``torch.Generator`` seeded with ``seed`` on the run's
device, ``2 * num_negatives`` draws a user a round, rejecting train and
test positives, until every user of the chunk has enough (at most 64
rounds); candidates ranked by (score descending, candidate position
ascending); DCG@k = sum over the top k of ``label / log2(rank + 1)``
(rank 0 weighted 1) over the user's test positives, averaged over all
users.  The draws are the only thing taken from the evaluator's design:
the same generator calls in the same order give the same candidates.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import sparse


def user_chunks(X, num_negatives: int, max_chunk: int = 4096,
                max_elems: int = 1 << 22):
    """``[(uids, pos_pad, pos_valid)]``: the chunks the evaluator draws
    for, in order."""
    U = X.shape[0]
    deg = np.diff(X.indptr)
    order = np.argsort(deg, kind="stable")

    def pow2(n):
        return 1 << max(int(n) - 1, 0).bit_length()

    chunks, start = [], 0
    while start < U:
        take = 1
        while take < max_chunk and start + take < U:
            P = pow2(max(int(deg[order[start + take]]), 1))
            if (take + 1) * (P + num_negatives) > max_elems:
                break
            take += 1
        sel = order[start:start + take]
        start += take
        p2 = pow2(take)
        P = pow2(max(int(deg[sel].max()), 1))
        uids = np.zeros(p2, np.int64)
        uids[:take] = sel
        lo, hi = X.indptr[sel], X.indptr[sel + 1]
        col = np.arange(P)[None, :]
        valid = np.zeros((p2, P), bool)
        valid[:take] = col < (hi - lo)[:, None]
        pos = np.zeros((p2, P), np.int64)
        pos[:take] = np.where(valid[:take], X.indices[
            np.where(valid[:take], lo[:, None] + col, 0)], 0)
        chunks.append((uids, pos, valid))
    return chunks


class AoaReference:
    """DCG@``k`` of tables against ``test``, negatives rejected against
    ``test + train``."""

    def __init__(self, test, train, *, k: int = 5, num_negatives: int = 100,
                 seed: int = 1234, device="cpu"):
        test = sparse.csr_matrix(test)
        test.sort_indices()
        self.U, self.I = test.shape
        self.k, self.nn, self.seed, self.dev = k, num_negatives, seed, device
        seen = (test + sparse.csr_matrix(train)).tocoo()
        keys = np.sort(seen.row.astype(np.int64) * self.I + seen.col)
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
        self.keys = torch.from_numpy(keys).to(device)
        self.chunks = [tuple(torch.from_numpy(a).to(device) for a in ch)
                       for ch in user_chunks(test, num_negatives)]
        self._cand = None

    def _seen(self, u, j):
        key = u * self.I + j
        pos = torch.searchsorted(self.keys, key).clamp(max=len(self.keys) - 1)
        return self.keys[pos] == key

    def _negatives(self, uids, gen):
        C, n, R = len(uids), self.nn, 2 * self.nn
        neg = torch.zeros((C, n), dtype=torch.int64, device=self.dev)
        have = torch.zeros(C, dtype=torch.int64, device=self.dev)
        for _ in range(64):
            if bool((have >= n).all()):
                break
            draws = torch.randint(0, self.I, (C, R), generator=gen,
                                  device=self.dev)
            ok = ~self._seen(uids[:, None].expand(C, R), draws)
            slot = have[:, None] + torch.cumsum(ok.long(), 1) - 1
            take = ok & (slot < n)
            r, c = torch.nonzero(take, as_tuple=True)
            neg[r, slot[r, c]] = draws[r, c]
            have = torch.clamp(have + ok.sum(1), max=n)
        return neg, torch.arange(n, device=self.dev)[None, :] < have[:, None]

    def _candidates(self):
        """Each chunk's ``(uids, cand, valid, P)``: the draws depend on the
        seed and the data alone, so every call shares them."""
        if self._cand is None:
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(self.seed)
            self._cand = []
            for uids, pos, pvalid in self.chunks:
                neg, nvalid = self._negatives(uids, gen)
                self._cand.append((uids, torch.cat([pos, neg], 1),
                                   torch.cat([pvalid, nvalid], 1),
                                   pos.shape[1]))
        return self._cand

    @torch.no_grad()
    def dcg(self, W, H, dtype=torch.float32) -> float:
        W = torch.as_tensor(W).to(self.dev, dtype)
        H = torch.as_tensor(H).to(self.dev, dtype)
        disc = torch.tensor([1.0] + [1.0 / math.log2(r + 1.0)
                                     for r in range(1, self.k)],
                            dtype=torch.float64, device=self.dev)
        total = torch.zeros((), dtype=torch.float64, device=self.dev)
        for uids, cand, valid, P in self._candidates():
            scores = (H[cand] * W[uids][:, None, :]).sum(-1).float()
            scores = torch.where(valid, scores,
                                 torch.full_like(scores, -torch.inf))
            order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
            top = order[:, :min(self.k, cand.shape[1])]
            labels = (top < P).double() * torch.gather(valid, 1, top).double()
            npos = valid[:, :P].sum(1).double()
            d = (labels * disc[:top.shape[1]]).sum(1)
            total += torch.where(npos > 0, d / npos.clamp_min(1),
                                 torch.zeros_like(d)).sum()
        return float(total) / max(self.U, 1)
