"""Full-catalog top-k with exclusions, in plain PyTorch, and its judge.

Scores ``W @ H^T`` a block of users at a time, the user's excluded items
at ``-inf``, and the items ranked by a stable descending sort, so equal
scores keep the lower item id first.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse

from .precision import matmul

BLOCK = 4096


def _block_scores(W, H, X, lo, hi, precision):
    s = matmul(W[lo:hi], H.T, precision)
    a, b = X.indptr[lo], X.indptr[hi]
    rows = np.repeat(np.arange(hi - lo), np.diff(X.indptr[lo:hi + 1]))
    cols = X.indices[a:b]
    s[torch.from_numpy(rows).to(s.device),
      torch.from_numpy(cols.astype(np.int64)).to(s.device)] = -torch.inf
    return s


@torch.no_grad()
def judge(W, H, X, k: int, scores, items):
    """``{"rank_gap": g, "score_err": e}`` of a top-``k`` answer
    ``(scores, items)`` (host arrays ``[U, k]``) for tables ``W``, ``H`` on
    their device and exclusions ``X``.  ``rank_gap``: the widest amount by
    which the reference's score of the item returned at rank r lies below
    the reference's r-th best score; ``score_err``: the widest gap between
    a returned score and the reference's score of that item.  Both over
    the largest reference score of the table, and infinite where an item
    is out of range, excluded or repeated in a row."""
    X = sparse.csr_matrix(X)
    dev = W.device
    U, I = W.shape[0], H.shape[0]
    items_t = torch.from_numpy(np.asarray(items, np.int64)).to(dev)
    scores_t = torch.from_numpy(np.asarray(scores, np.float32)).to(dev)
    if bool(((items_t < 0) | (items_t >= I)).any()):
        return {"rank_gap": float("inf"), "score_err": float("inf")}
    srt = torch.sort(items_t, 1)[0]
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        return {"rank_gap": float("inf"), "score_err": float("inf")}
    gap = err = scale = 0.0
    for lo in range(0, U, BLOCK):
        hi = min(lo + BLOCK, U)
        s = _block_scores(W, H, X, lo, hi, "float32")
        best = torch.sort(s, dim=1, descending=True, stable=True)[0][:, :k]
        got = torch.gather(s, 1, items_t[lo:hi])
        gap = max(gap, float((best - got).max()))
        err = max(err, float((scores_t[lo:hi] - got).abs().max()))
        scale = max(scale, float(best[:, 0][torch.isfinite(best[:, 0])]
                                 .abs().max()))
    return {"rank_gap": gap / scale, "score_err": err / scale}


@torch.no_grad()
def topk(W, H, X, k: int, *, precision: str = "float32"):
    """The reference's own answer ``(scores, items)`` as host arrays, its
    products in ``precision``: the lower-precision control puts it in the
    program's place."""
    X = sparse.csr_matrix(X)
    U = W.shape[0]
    out_s = np.empty((U, k), np.float32)
    out_i = np.empty((U, k), np.int32)
    for lo in range(0, U, BLOCK):
        hi = min(lo + BLOCK, U)
        s = _block_scores(W, H, X, lo, hi, precision)
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        out_s[lo:hi] = v[:, :k].cpu().numpy()
        out_i[lo:hi] = i[:, :k].to(torch.int32).cpu().numpy()
    return out_s, out_i
