"""A WMF fit (implicit ALS, Hu, Koren and Volinsky 2008) in plain PyTorch.

Each epoch solves the user side from the items, then the item side from
the users.  For a target row with positives P over the source table Y:

    A = Y^T Y + wd I + (c - 1) sum_{i in P} y_i y_i^T,   b = c sum_{i in P} y_i

and the row becomes ``A^{-1} b``, or zeros when P is empty.  The rows are
taken in blocks of similar degree (a padded gather, one batched product,
batched Cholesky); no block is ever as large as the whole table.

:func:`residual` judges a half sweep from given tables: the relative
residual ``|A x - b| / |b|`` of each row's normal equations, in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from .precision import matmul

# rows x padded degree of one block's gather, and rows of one block
MAX_GATHER = 1 << 21
MAX_ROWS = 4096


def blocks(X):
    """Row blocks of CSR ``X`` in ascending degree: ``(rows, P)`` each."""
    deg = np.diff(X.indptr)
    order = np.argsort(deg, kind="stable")
    order = order[deg[order] > 0]
    out, start = [], 0
    while start < len(order):
        take = 1
        while (take < MAX_ROWS and start + take < len(order)
               and (take + 1) * int(deg[order[start + take]]) <= MAX_GATHER):
            take += 1
        rows = order[start:start + take]
        out.append((rows, int(deg[rows[-1]])))
        start += take
    return out


def _gather_index(X, rows, P, device):
    """``(idx [n, P], valid [n, P])`` on ``device``: each row's positives,
    padded with index 0 and ``valid`` False."""
    lo, hi = X.indptr[rows], X.indptr[rows + 1]
    lens = hi - lo
    col = np.arange(P)[None, :]
    valid = col < lens[:, None]
    pos = np.where(valid, lo[:, None] + col, 0)
    idx = X.indices[pos].astype(np.int64) * valid
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(valid).to(device))


def _gather(idx, valid, Y):
    return Y[idx] * valid[..., None].to(Y.dtype)


class AlsReference:
    """The fit's tables on ``device``; :meth:`epoch` runs one epoch.
    ``keep`` (a fault for the harness's own tests) solves only that share
    of each block's rows.  ``precision`` is that of the products (the
    Gramian and the corrections): ``"float32"``, or ``"tf32"`` for the
    lower-precision control."""

    def __init__(self, X, W0, H0, *, weight: float, weight_decay: float,
                 device, keep: float = 1.0, precision: str = "float32"):
        self.precision = precision
        self.X = X.tocsr()
        self.Xt = self.X.T.tocsr()
        self.Xt.sort_indices()
        self.c, self.wd, self.keep = float(weight), float(weight_decay), keep
        self.W = torch.as_tensor(W0).to(device, torch.float32).clone()
        self.H = torch.as_tensor(H0).to(device, torch.float32).clone()
        self.blk = {side: [(torch.from_numpy(rows).to(device),
                            *_gather_index(M, rows, P, device))
                           for rows, P in blocks(M)]
                    for side, M in (("W", self.X), ("H", self.Xt))}
        # the target rows with no positive, which every sweep zeroes
        self.empty = {
            side: torch.from_numpy(np.flatnonzero(np.diff(M.indptr) == 0)
                                   ).to(device)
            for side, M in (("W", self.X), ("H", self.Xt))}

    def _half(self, target: str):
        T, Y = (self.W, self.H) if target == "W" else (self.H, self.W)
        K = Y.shape[1]
        p = self.precision
        A0 = matmul(Y.T, Y, p) + self.wd * torch.eye(K, dtype=Y.dtype,
                                                    device=Y.device)
        for rows, idx, valid in self.blk[target]:
            if self.keep < 1.0:
                n = max(1, int(len(rows) * self.keep))
                rows, idx, valid = rows[:n], idx[:n], valid[:n]
            Yp = _gather(idx, valid, Y)
            A = A0 + (self.c - 1.0) * matmul(Yp.transpose(1, 2), Yp, p)
            b = self.c * Yp.sum(1)
            T[rows] = torch.cholesky_solve(b[..., None],
                                           torch.linalg.cholesky(A))[..., 0]
        T[self.empty[target]] = 0

    @torch.no_grad()
    def epoch(self, e: int) -> None:
        self._half("W")
        self._half("H")

    def tables(self):
        return self.W, self.H


@torch.no_grad()
def residual(X, T, Y, *, weight: float, weight_decay: float) -> float:
    """Largest relative residual ``|A t - b| / |b|`` over the rows of ``T``
    with positives, each row's normal equations over source ``Y`` (see the
    module docstring), in float64."""
    X = X.tocsr()
    T64, Y64 = T.double(), Y.double()
    K = Y.shape[1]
    A0 = Y64.T @ Y64 + weight_decay * torch.eye(K, dtype=torch.float64,
                                                 device=Y.device)
    worst = 0.0
    for rows, P in blocks(X):
        idx, valid = _gather_index(X, rows, P, Y.device)
        Yp = _gather(idx, valid, Y64)
        t = T64[torch.from_numpy(rows).to(T.device)]
        s = torch.einsum("npk,nk->np", Yp, t)
        At = t @ A0 + (weight - 1.0) * torch.einsum("np,npk->nk", s, Yp)
        b = weight * Yp.sum(1)
        r = (At - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-300)
        worst = max(worst, float(r.max()))
    return worst


def reference(X, W0, H0, cfg: dict, sizes: dict, *, shuffle_seed: int,
              fit_seed: int, device, control: bool = False,
              keep: float = 1.0) -> AlsReference:
    """The fit a configuration of ``model: WMF`` describes (it draws
    nothing, so the seeds go unused); ``control``: TF32 products."""
    h = cfg["hyper"]
    return AlsReference(X, W0, H0, weight=h["weight"],
                        weight_decay=h["weight_decay"], device=device,
                        keep=keep,
                        precision="tf32" if control else "float32")


def judge(ref: AlsReference, W, H, X, cfg: dict) -> dict:
    """``H_resid``: the program's last half sweep judged by its own
    normal equations (:func:`residual`)."""
    Xt = X.T.tocsr()
    Xt.sort_indices()
    dev = ref.W.device
    h = cfg["hyper"]
    return {"H_resid": residual(Xt, torch.as_tensor(H).to(dev),
                                torch.as_tensor(W).to(dev),
                                weight=h["weight"],
                                weight_decay=h["weight_decay"])}


def work(ref: AlsReference, X, sizes: dict, epochs: int) -> tuple:
    """``(flops, bytes)`` of ``epochs`` sweeps over ``X``, both halves."""
    K = sizes["num_components"]
    fu = roofline.wmf_half_sweep(np.diff(X.indptr), sizes["num_item"], K)
    fi = roofline.wmf_half_sweep(np.diff(ref.Xt.indptr), sizes["num_user"],
                                 K)
    return (fu[0] + fi[0]) * epochs, (fu[1] + fi[1]) * epochs
