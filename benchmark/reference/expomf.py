"""An ExpoMF fit (exposure matrix factorisation: Liang, Charlin,
McInerney and Blei, "Modeling User Exposure in Recommendation", WWW 2016)
in plain float32 PyTorch.

Each EM epoch starts from the tables ``(W0, H0)`` and the priors ``mu``.
E-step, for every cell (u, i) of the user x item matrix:

    n_ui = c exp(-lam_y (w_u . h_i)^2 / 2),   c = sqrt(lam_y / (2 pi))
    E_ui = (n_ui + 1e-8) / (n_ui + 1e-8 + (1 - mu_i) / mu_i)

and ``E_ui = 1`` where u clicked i.  M-step: each user over ``H0``,

    A = (wd / lam_y) I + lam_y sum_{all i} E_ui h_i h_i^T,
    b = lam_y sum_{i clicked} h_i,   w_u = A^{-1} b,

then each item the same over the *updated* W with the same, epoch-start
exposure, and last ``mu_i = (a1 + sum_u E_ui - 1) / (a1 + a2 + U - 2)``
with a Beta(1, 1) prior (``a1 = a2 = 1``).

Departures from the paper, each taken from the original implementation
(cymf's ``expomf.pyx``) so that the same model is computed: the ridge is
``(wd / lam_y) I`` where the paper writes ``lam_theta I`` (the same at
``lam_y = 1``); ``1e-8`` is added to ``n`` in the posterior; ``mu`` starts
at the configuration's ``init_mu``.  A row with no click gets ``b = 0``
and so a zero solution, as the paper's update gives.

The rows are taken in small blocks.  For a block of rows the exposure is
one score product; each row's Gramian is ``(Y * E_r[:, None])^T Y``, and
the block's are one product of the weighted copies ``[rows * K, Co]``
with ``Y``.  No block holds more than :data:`MAX_ELEMS` elements of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import matmul

# elements of one row block's weighted copies of Y (1 GiB)
MAX_ELEMS = 1 << 28


class ExpoReference:
    """The fit's tables and priors on ``device``; :meth:`epoch` runs one
    EM epoch.  ``keep`` (a fault for the harness's own tests) solves only
    that share of each block's rows.  ``precision`` is that of the
    products (the scores, the Gramians, the right-hand sides):
    ``"float32"``, or ``"tf32"`` for the lower-precision control."""

    def __init__(self, X, W0, H0, *, lam_y: float, weight_decay: float,
                 init_mu: float, device, keep: float = 1.0,
                 precision: str = "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.precision, self.keep = precision, keep
        self.X = X.tocsr()
        self.X.sort_indices()
        self.Xt = self.X.T.tocsr()
        self.Xt.sort_indices()
        self.lam_y = float(lam_y)
        self.ridge = float(weight_decay) / self.lam_y
        self.c = math.sqrt(self.lam_y / (2.0 * math.pi))
        self.a1 = self.a2 = 1.0
        self.W = torch.as_tensor(W0).to(device, torch.float32).clone()
        self.H = torch.as_tensor(H0).to(device, torch.float32).clone()
        self.mu = torch.full((self.X.shape[1],), float(init_mu),
                             dtype=torch.float32, device=device)
        # each side's clicks: (indptr on the host, row and column ids)
        self.clicks = {}
        for side, M in (("W", self.X), ("H", self.Xt)):
            rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
            self.clicks[side] = (M.indptr,
                                 torch.from_numpy(rows).to(device),
                                 torch.from_numpy(M.indices.astype(np.int64))
                                 .to(device))

    def _sweep(self, side: str, T, S_src, S_other, Y, mu_term, by_col: bool):
        """Solve every row of ``T`` (in place): the exposure from
        ``S_src`` (this side's epoch-start table) and ``S_other`` (the
        other side's), the normal equations over ``Y``.  ``mu_term`` is
        ``(1 - mu) / mu`` by column (the user sweep) or by row (the item
        sweep).  Returns the exposure's column sums."""
        indptr, crow, ccol = self.clicks[side]
        n_rows, K = T.shape
        Co = Y.shape[0]
        p = self.precision
        Yt = Y.T.contiguous()
        eye = torch.eye(K, dtype=torch.float32, device=Y.device)
        colsum = torch.zeros(Co, dtype=torch.float32, device=Y.device)
        step = max(1, MAX_ELEMS // (Co * K))
        for s in range(0, n_rows, step):
            e = min(s + step, n_rows)
            lo, hi = int(indptr[s]), int(indptr[e])
            clicked = torch.zeros((e - s, Co), dtype=torch.float32,
                                  device=Y.device)
            clicked[crow[lo:hi] - s, ccol[lo:hi]] = 1.0
            scores = matmul(S_src[s:e], S_other.T, p)
            n = self.c * torch.exp(-self.lam_y * scores.square() / 2.0)
            m = mu_term[None, :] if by_col else mu_term[s:e, None]
            E = torch.where(clicked > 0, 1.0, (n + 1e-8) / (n + 1e-8 + m))
            colsum += E.sum(0)
            if self.keep < 1.0:
                r = max(1, int((e - s) * self.keep))
                e, E, clicked = s + r, E[:r], clicked[:r]
            # each row's (Y * E_r[:, None])^T Y, the block's in one product
            G = matmul((E[:, None, :] * Yt[None]).reshape(-1, Co), Y, p)
            A = self.ridge * eye + self.lam_y * G.view(-1, K, K)
            b = self.lam_y * matmul(clicked, Y, p)
            T[s:e] = torch.cholesky_solve(b[..., None],
                                          torch.linalg.cholesky(A))[..., 0]
        return colsum

    @torch.no_grad()
    def epoch(self, e: int) -> None:
        W0, H0 = self.W.clone(), self.H.clone()
        mu_term = (1.0 - self.mu) / self.mu
        colsum = self._sweep("W", self.W, W0, H0, H0, mu_term, by_col=True)
        self._sweep("H", self.H, H0, W0, self.W, mu_term, by_col=False)
        U = self.X.shape[0]
        self.mu = (self.a1 + colsum - 1.0) / (self.a1 + self.a2 + U - 2.0)

    def tables(self):
        return self.W, self.H


def reference(X, W0, H0, cfg: dict, sizes: dict, *, shuffle_seed: int,
              fit_seed: int, device, control: bool = False,
              keep: float = 1.0) -> ExpoReference:
    """The fit a configuration of ``model: ExpoMF`` describes (it draws
    nothing, so the seeds go unused); ``control``: TF32 products."""
    h = cfg["hyper"]
    return ExpoReference(X, W0, H0, lam_y=h["lam_y"],
                         weight_decay=h["weight_decay"],
                         init_mu=cfg["init_mu"], device=device, keep=keep,
                         precision="tf32" if control else "float32")


def judge(ref: ExpoReference, W, H, X, cfg: dict) -> dict:
    """Nothing beyond ``W_rel`` and ``H_rel``."""
    return {}


def half_sweep(degrees, n_other: int, n_tables: int, K: int) -> tuple:
    """``(flops, bytes)`` of one ExpoMF half sweep's least work, over the
    target rows with a click (``R``) and the ``n_other`` rows of the other
    side: the scores 2 R Co K, the exposure ~10 R Co, the symmetric
    exposure-weighted Gramians R Co K (K + 1) (each distinct product of a
    row pair once), the right-hand sides 2 p K over the p clicks and a
    Cholesky solve K^3 / 3 + 2 K^2 a row; bytes: both tables read
    (``n_tables`` rows), the target written, the click ids read."""
    deg = np.asarray(degrees, np.float64)
    R, p = float((deg > 0).sum()), float(deg.sum())
    Co = float(n_other)
    flops = (2.0 * R * Co * K + 10.0 * R * Co + R * Co * K * (K + 1)
             + 2.0 * p * K + R * (K ** 3 / 3.0 + 2.0 * K * K))
    nbytes = (n_tables * K + len(deg) * K + p) * 4.0
    return flops, nbytes


def work(ref: ExpoReference, X, sizes: dict, epochs: int) -> tuple:
    """``(flops, bytes)`` of ``epochs`` EM epochs over ``X``: both half
    sweeps and ``mu`` written."""
    K = sizes["num_components"]
    U, I = X.shape
    fu = half_sweep(np.diff(X.indptr), I, U + I, K)
    fi = half_sweep(np.diff(ref.Xt.indptr), U, U + I, K)
    return (fu[0] + fi[0]) * epochs, (fu[1] + fi[1] + I * 4.0) * epochs
