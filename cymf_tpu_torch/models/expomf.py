"""Exposure Matrix Factorization (Liang et al. 2016).  Port of
`cymf_tpu/models/expomf.py`, its single-device branch.

EM with exposure-weighted ALS (`cymf/expomf.pyx`).  Per epoch, with
epoch-start factors (W0, H0):

E-step (`expomf.pyx:134-137`):
    n_ui  = prefactor * exp(-lam_y * (W0 H0^T)_{ui}^2 / 2)
    E_ui  = (n_ui + 1e-8) / (n_ui + 1e-8 + (1 - mu_i) / mu_i);  E = 1 at
    observed cells.
M-step (`expomf.pyx:165-204`): per user u,
    A = (wd / lam_y) I + lam_y * sum_{ALL items j} E_uj h_j h_j^T
    b = lam_y * sum_{observed j} h_j          (E = 1 there)
then the symmetric item sweep with Y = the *updated* W but the
*epoch-start* exposure; finally mu_i = (a1 + sum_u E_ui - 1) /
(a1 + a2 + U - 2) with a Beta(1, 1) prior (`expomf.pyx:113-114,142`).

The dense U x I exposure matrix is never formed: each chunk recomputes its
E block from (W0, H0) with one product and folds it into the weighted
Gramian.  The systems go to the ALS solvers of `ops/als.py`.

The Gaussian prefactor defaults to the paper's ``sqrt(lam_y / (2 pi))``;
the reference's ``sqrt(lam_y / 2.0*M_PI)`` is ``sqrt(lam_y pi / 2)`` by
precedence (pass ``prefactor=`` to replicate it).

``fit(checkpoint_path=p)`` saves ``{"W", "H", "mu"}``, the JAX
package's schema, and ``resume=True`` continues from it.  Not ported yet
(ROADMAP.md, queue 1): the multi-device branch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops.als import (build_chunks, gather_rows, get_solver,
                       place_device_chunks, resolve_chol_solver)
from ..utils.checkpoint import resume_state
from .base import (MFTrainerBase, PersistenceMixin, as_csr,
                   require_one_device)
# elements of (Y (x) Y) formed at once in the weighted Gramian (1 GiB)
_GRAM_ELEMS = 1 << 28


def weighted_gramian(E: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``sum_i E[c, i] y_i y_i^T`` for every row c of ``E (C, I)``:
    ``(C, K, K)``.

    Written as ``E @ (Y (x) Y).reshape(I, K*K)`` over row blocks of ``Y``:
    each block's outer products are formed and taken into the sum by one
    ``addmm`` with E's matching columns.  No ``(C, I, K)`` tensor exists,
    and at most ``_GRAM_ELEMS`` elements of ``Y (x) Y``.
    """
    I, K = Y.shape
    out = torch.zeros((E.shape[0], K * K), dtype=Y.dtype, device=Y.device)
    step = max(1, _GRAM_ELEMS // (K * K))
    for s in range(0, I, step):
        Yb = Y[s:s + step]
        out.addmm_(E[:, s:s + step], (Yb[:, :, None] * Yb[:, None, :])
                   .reshape(len(Yb), K * K))
    return out.view(-1, K, K)


def expomf_chunk(E_src, E_other, Y, mu_term, rows, idx_pad, valid,
                 lam_y: float, ridge, prefactor: float, *, solver: str):
    """Solve one chunk of rows, users or items (symmetric by arguments).

    ``E_src [R, K]``: this side's epoch-start factors; ``E_other [Co, K]``:
    the other side's, whose rows are E's columns; ``Y [Co, K]``: the
    other-side table of the normal equations (the item sweep passes the
    updated W while E still uses W0); ``mu_term``: ``(1-mu)/mu`` as
    ``[Co]`` (per column) or ``[C, 1]`` (per row).  Every row of the chunk
    is real (:func:`~cymf_tpu_torch.ops.als.place_device_chunks` dropped
    the sentinels).

    Returns ``(new_rows [C, K], e_colsum [Co])``, the column sums of the
    chunk's E for the mu update.
    """
    C = rows.shape[0]
    Co = E_other.shape[0]
    S = E_src.index_select(0, rows) @ E_other.T                # [C, Co]
    n = prefactor * torch.exp(-lam_y * S.square() / 2.0)
    post = (n + 1e-8) / (n + 1e-8 + mu_term)
    # observed cells -> exposure 1 (expomf.pyx:135-137); pads go to a
    # spare column that is cut off
    obs_idx = torch.where(valid, idx_pad.long(), Co)
    obs = torch.zeros((C, Co + 1), dtype=torch.bool,
                      device=S.device).scatter_(1, obs_idx, True)
    E = torch.where(obs[:, :Co], 1.0, post)
    e_colsum = E.sum(dim=0)
    A = ridge + lam_y * weighted_gramian(E, Y)
    b = lam_y * gather_rows(Y, idx_pad, valid).sum(dim=1)     # E=1 observed
    x = get_solver(solver)(A, b)
    return torch.where(valid.any(dim=1, keepdim=True), x, 0.0), e_colsum


class ExpoMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.ExpoMF`` (`expomf.pyx:40-64`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU.
    After a fit, ``mu`` holds the per-item exposure priors."""

    def __init__(self, num_components: int = 20, lam_y: float = 1.0,
                 weight_decay: float = 0.01, chunk_size: int = 512,
                 solver: str = "cholesky",
                 prefactor: Optional[float] = None, device=None):
        super().__init__(num_components, device=device)
        self.lam_y = float(lam_y)
        self.weight_decay = float(weight_decay)
        self.chunk_size = int(chunk_size)
        if solver not in ("cholesky", "lu"):
            raise ValueError("solver must be 'cholesky' or 'lu'")
        self.solver = solver
        self.prefactor = (math.sqrt(self.lam_y / (2.0 * math.pi))
                          if prefactor is None else float(prefactor))

    def _ensure_tables(self, num_rows_w: int, num_rows_h: int) -> None:
        """randn * 0.01 init with np.random.seed(4321) before W only
        (`expomf.pyx:92-96`), in place of the uniform base init."""
        K = self.num_components
        if self.W is None:
            np.random.seed(4321)
            self.W = np.random.randn(num_rows_w, K) * 0.01
        if self.H is None:
            self.H = np.random.randn(num_rows_h, K) * 0.01

    @torch.no_grad()
    def fit(self, X, num_epochs: int = 5, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = True, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train; signature parity with `expomf.pyx`.  ``num_threads`` is
        accepted and ignored.  ``checkpoint_path``, ``checkpoint_every``
        and ``resume`` as ``BPR.fit``."""
        require_one_device("ExpoMF")
        X = as_csr(X)
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()
        dev = self.device
        K = self.num_components
        solver_r = resolve_chol_solver(self.solver, K, dev)

        U, I = X.shape
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)

        Xt = X.T.tocsr()
        Xt.sort_indices()
        user_chunks = place_device_chunks(
            build_chunks(X, self.chunk_size, U, num_components=K), dev, U)
        item_chunks = place_device_chunks(
            build_chunks(Xt, self.chunk_size, I, num_components=K), dev, I)

        dtype = config.param_dtype()

        def put(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        self._state, start_epoch = resume_state(
            checkpoint_path, resume,
            {"W": put(self.W), "H": put(self.H),
             "mu": torch.full((I,), 0.01, dtype=dtype,
                              device=dev)})                # expomf.pyx:111
        ridge = (self.weight_decay / self.lam_y) * torch.eye(
            K, dtype=dtype, device=dev)                    # expomf.pyx:171
        lam_y, prefactor = self.lam_y, self.prefactor
        a1 = a2 = 1.0  # Beta(1, 1) prior (expomf.pyx:113-114,142)

        def epoch_fn(epoch):
            st = self._state
            # epoch-start copies: the sweeps update the tables in place
            W0, H0 = st["W"].clone(), st["H"].clone()
            mu_term = (1.0 - st["mu"]) / st["mu"]                 # [I]

            # user sweep (Y = H0) and the column sums of the exposure
            colsum = torch.zeros((I,), dtype=dtype, device=dev)
            for ch in user_chunks:
                x, cs = expomf_chunk(W0, H0, H0, mu_term, ch.rows,
                                     ch.idx_pad, ch.valid, lam_y, ridge,
                                     prefactor, solver=solver_r)
                st["W"].index_copy_(0, ch.rows, x)
                colsum += cs

            # item sweep: E from (W0, H0), normal equations over the
            # updated W
            for ch in item_chunks:
                x, _ = expomf_chunk(H0, W0, st["W"],
                                    mu_term.index_select(0, ch.rows)[:, None],
                                    ch.rows, ch.idx_pad, ch.valid, lam_y,
                                    ridge, prefactor, solver=solver_r)
                st["H"].index_copy_(0, ch.rows, x)

            st["mu"] = (a1 + colsum - 1.0) / (a1 + a2 + U - 2.0)

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        state = self._state  # a best-epoch restore drops self._state
        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, checkpoint_path, checkpoint_every,
                         start_epoch)
        # the last epoch's, as in the JAX package
        self.mu = state["mu"].cpu().numpy()
        self._drop_device_state()
