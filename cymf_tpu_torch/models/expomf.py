"""Exposure Matrix Factorization (Liang et al. 2016).  Port of
`cymf_tpu/models/expomf.py`.

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

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) both
tables are row-sharded, each chunk's rows split over the ranks, and the
exposure block is split by the other side's rows
(``parallel/shard_step.py::sharded_expomf_chunk``, the JAX package's
``shard_map`` branch).  ``mu`` is row-sharded like the item table (the
JAX package replicates it): each rank updates the priors of its own
items from its own exposure column sums, and ``model.mu`` is gathered at
the end of the fit.

``fit(checkpoint_path=p)`` saves ``{"W", "H", "mu"}``, the JAX
package's schema, and ``resume=True`` continues from it, whatever row
padding (number of ranks, or the JAX package's devices) wrote it.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops.als import (build_chunks, gather_rows, get_solver,
                       place_device_chunks, place_mesh_chunks,
                       resolve_chol_solver, weighted_gramian)
from ..config import scalar
from ..parallel.mesh import fetch_to_host, host_array
from ..parallel.shard_step import rows_everywhere, sharded_expomf_chunk
from ..utils.checkpoint import resume_state
from ..utils.profiling import span, spanned, upload
from .base import MFTrainerBase, PersistenceMixin, as_csr, padded_rows


def exposure(src_rows, E_other, mu_term, idx_pad, valid, lam_y,
             prefactor) -> torch.Tensor:
    """The exposure posterior of a chunk's rows, ``[C, Co]`` float32
    (`expomf.pyx:134-137`): ``src_rows [C, K]`` are the rows' epoch-start
    factors, ``E_other [Co, K]`` the other side's, ``mu_term`` is
    ``(1-mu)/mu`` as ``[Co]`` or ``[C, 1]``, and the observed cells
    (``idx_pad`` where ``valid``) are 1."""
    C, Co = src_rows.shape[0], E_other.shape[0]
    S = src_rows.float() @ E_other.float().T                # [C, Co]
    n = prefactor * torch.exp(-lam_y * S.square() / 2.0)
    post = (n + 1e-8) / (n + 1e-8 + mu_term)
    # the pads go to a spare column that is cut off
    obs_idx = torch.where(valid, idx_pad.long(), Co)
    obs = torch.zeros((C, Co + 1), dtype=torch.bool,
                      device=S.device).scatter_(1, obs_idx, True)
    return torch.where(obs[:, :Co], 1.0, post)


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
    chunk's E for the mu update, in float32.  Under a bfloat16 param dtype
    ``lam_y`` and ``prefactor`` are rounded to it, as the JAX package
    places them; the scores, the exposure and the Gramian are float32,
    ``b`` is in the param dtype.

    Spans: ``expomf.exposure`` (the score product, the exposure, the
    observed cells and the column sums), ``expomf.gramian`` (the
    exposure-weighted Gramian and the ridge) and ``expomf.solve`` (the
    right-hand side and the solver).
    """
    lam_y, prefactor = (scalar(v, Y.dtype) for v in (lam_y, prefactor))
    with span("expomf.exposure"):
        E = exposure(E_src.index_select(0, rows), E_other, mu_term, idx_pad,
                     valid, lam_y, prefactor)
        e_colsum = E.sum(dim=0)
    with span("expomf.gramian"):
        A = ridge + lam_y * weighted_gramian(E, Y)
    with span("expomf.solve"):
        b = lam_y * gather_rows(Y, idx_pad, valid).sum(dim=1)  # E=1 observed
        x = get_solver(solver)(A, b)
        x = torch.where(valid.any(dim=1, keepdim=True), x, 0.0)
    return x, e_colsum


class ExpoMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.ExpoMF`` (`expomf.pyx:40-64`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU.
    After a fit, ``mu`` holds the per-item exposure priors and
    ``epoch_times_`` each epoch's seconds."""

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
    @spanned("expomf.fit")
    def fit(self, X, num_epochs: int = 5, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = True, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train; signature parity with `expomf.pyx`.  ``num_threads`` is
        accepted and ignored.  ``checkpoint_path``, ``checkpoint_every``
        and ``resume`` as ``BPR.fit``.

        The fit is a span ``expomf.fit``: ``expomf.build`` (the transpose,
        both sides' chunks and their placement), ``expomf.upload`` (the
        tables and mu), then each epoch's span, which holds each chunk's
        spans on one device (:func:`expomf_chunk`), and ``tables.fetch``
        at the end."""
        X = as_csr(X)
        mesh = self._mesh_device()
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
        if mesh.num_devices > 1:
            self._fit_sharded(X, mesh, solver_r, num_epochs, verbose,
                              checkpoint_path, checkpoint_every, resume)
            return

        with span("expomf.build"):
            Xt = X.T.tocsr()
            Xt.sort_indices()
            user_chunks = place_device_chunks(
                build_chunks(X, self.chunk_size, U, num_components=K), dev, U)
            item_chunks = place_device_chunks(
                build_chunks(Xt, self.chunk_size, I, num_components=K), dev,
                I)
        self._samples_per_epoch = X.nnz
        dtype = config.param_dtype()

        def put(a):
            # a copy on the CPU too: the sweeps write the tables in place
            return upload(torch.from_numpy(np.asarray(a, np.float32)), dev,
                          dtype, copy=True)

        with span("expomf.upload"):
            self._state, start_epoch = resume_state(
                checkpoint_path, resume,
                {"W": put(self.W), "H": put(self.H),
                 "mu": put(np.full(I, 0.01))},             # expomf.pyx:111
                {"W": U, "H": I, "mu": I})
        ridge = (self.weight_decay / self.lam_y) * torch.eye(
            K, dtype=dtype, device=dev)                    # expomf.pyx:171
        lam_y, prefactor = self.lam_y, self.prefactor
        a1 = a2 = 1.0  # Beta(1, 1) prior (expomf.pyx:113-114,142)

        def epoch_fn(epoch):
            st = self._state
            # epoch-start copies: the sweeps update the tables in place
            W0, H0 = st["W"].clone(), st["H"].clone()
            mu_term = (1.0 - st["mu"]) / st["mu"]                 # [I]

            # user sweep (Y = H0) and the column sums of the exposure (in
            # float32, the exposure's dtype, as in the JAX package)
            colsum = torch.zeros((I,), dtype=torch.float32, device=dev)
            for ch in user_chunks:
                x, cs = expomf_chunk(W0, H0, H0, mu_term, ch.rows,
                                     ch.idx_pad, ch.valid, lam_y, ridge,
                                     prefactor, solver=solver_r)
                st["W"].index_copy_(0, ch.rows, x.to(dtype))
                colsum += cs

            # item sweep: E from (W0, H0), normal equations over the
            # updated W
            for ch in item_chunks:
                x, _ = expomf_chunk(H0, W0, st["W"],
                                    mu_term.index_select(0, ch.rows)[:, None],
                                    ch.rows, ch.idx_pad, ch.valid, lam_y,
                                    ridge, prefactor, solver=solver_r)
                st["H"].index_copy_(0, ch.rows, x.to(dtype))

            st["mu"] = ((a1 + colsum - 1.0) / (a1 + a2 + U - 2.0)).to(dtype)

        self._run_expomf(num_epochs, epoch_fn, verbose, checkpoint_path,
                         checkpoint_every, start_epoch)

    def _fit_sharded(self, X, mesh, solver_r, num_epochs, verbose,
                     checkpoint_path, checkpoint_every, resume):
        """The mesh branch of ``cymf_tpu.ExpoMF.fit``: W, H and mu
        row-sharded over the ranks (rows padded by ``mesh.pad_rows``),
        each chunk's rows split over them
        (:func:`~cymf_tpu_torch.parallel.shard_step.sharded_expomf_chunk`).
        The pad items keep mu = 0.01 and a ``(1 - mu) / mu`` of 1; the
        exposure of the pad rows and columns is masked out."""
        dev, p = self.device, mesh.rank
        K = self.num_components
        U, I = X.shape
        Up, Ip = mesh.pad_rows(U), mesh.pad_rows(I)
        with span("expomf.build"):
            Xt = X.T.tocsr()
            Xt.sort_indices()
            user_chunks = place_mesh_chunks(
                build_chunks(X, self.chunk_size, Up, num_components=K), mesh)
            item_chunks = place_mesh_chunks(
                build_chunks(Xt, self.chunk_size, Ip, num_components=K),
                mesh)
        self._samples_per_epoch = X.nnz
        dtype = config.param_dtype()

        state, start_epoch = resume_state(
            checkpoint_path, resume,
            {"W": padded_rows(self.W, Up), "H": padded_rows(self.H, Ip),
             "mu": torch.full((Ip,), 0.01, dtype=dtype)},  # expomf.pyx:111
            {"W": U, "H": I, "mu": I})
        mesh.agree(start_epoch, "the checkpoint's epoch")
        with span("expomf.upload"):
            self._state = {k: mesh.put_table(v) for k, v in state.items()}
        self._sharded_keys = frozenset(self._state)
        ridge = (self.weight_decay / self.lam_y) * torch.eye(
            K, dtype=dtype, device=dev)                    # expomf.pyx:171
        kw = dict(lam_y=self.lam_y, ridge=ridge, prefactor=self.prefactor,
                  solver=solver_r)
        a1 = a2 = 1.0  # Beta(1, 1) prior (expomf.pyx:113-114,142)
        rpd_i = Ip // mesh.num_devices
        # this rank's items, and which of them are real
        live = (torch.arange(rpd_i, device=dev) + p * rpd_i) < I

        def epoch_fn(epoch):
            st = self._state
            W0, H0 = st["W"].clone(), st["H"].clone()
            mu_term = torch.where(live, (1.0 - st["mu"]) / st["mu"], 1.0)

            # user sweep: mu by column, this rank's items; float32, and so
            # mu after the first epoch, as in the JAX package's mesh form
            colsum = torch.zeros((rpd_i,), dtype=torch.float32, device=dev)
            for ch in user_chunks:
                colsum += sharded_expomf_chunk(
                    mesh, W0, H0, H0, mu_term, st["W"], ch, mu_axis="col",
                    num_real_rows=U, num_real_cols=I, **kw)

            # item sweep: mu by row, the chunk's items on every rank
            for ch in item_chunks:
                mu_rows = rows_everywhere(mesh, mu_term[:, None],
                                          ch.rows)[:, 0]
                sharded_expomf_chunk(
                    mesh, H0, W0, st["W"], mu_rows, st["H"], ch,
                    mu_axis="row", num_real_rows=I, num_real_cols=U, **kw)

            st["mu"] = torch.where(
                live, (a1 + colsum - 1.0) / (a1 + a2 + U - 2.0), st["mu"])

        self._run_expomf(num_epochs, epoch_fn, verbose, checkpoint_path,
                         checkpoint_every, start_epoch)

    def _run_expomf(self, num_epochs, epoch_fn, verbose, checkpoint_path,
                    checkpoint_every, start_epoch):
        """The epoch loop of either branch: ``epoch_times_`` holds each
        epoch's seconds (synchronised on the card), ``mu`` the last
        epoch's priors."""
        dev = self.device
        self.epoch_times_ = []

        def timed(epoch):
            t0 = time.perf_counter()
            epoch_fn(epoch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(time.perf_counter() - t0)

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        state = self._state  # a best-epoch restore drops self._state
        sharded = "mu" in self._sharded_keys
        self._run_epochs(num_epochs, timed, snapshot_fn, restore_fn,
                         verbose, checkpoint_path, checkpoint_every,
                         start_epoch)
        # the last epoch's, as in the JAX package; gathered from the ranks
        # where it is sharded
        self.mu = (fetch_to_host(state["mu"], self.mesh) if sharded
                   else host_array(state["mu"]))[:self._num_items]
        self._drop_device_state()
