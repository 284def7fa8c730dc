"""Weighted Matrix Factorization / implicit ALS (Hu, Koren, Volinsky 2008).
Port of `cymf_tpu/models/wmf.py`.

Per epoch, alternate closed-form least-squares sweeps over users then
items (`cymf/wmf.pyx`).  For each row r with positive set P(r) over the
other-side table Y:

    A = Y^T Y + wd*I + (c-1) * sum_{i in P(r)} y_i y_i^T
    b = c * sum_{i in P(r)} y_i
    row <- A^{-1} b          (zeros when P(r) is empty, `wmf.pyx:154-156`)

with confidence weight ``c`` (default 10, `wmf.pyx:46`).  Rows are solved
in degree-bucketed batches (`ops/als.py`): the Gramian is one product,
each chunk's corrections one batched product, and the systems go to
batched Cholesky (LU optional, as the reference's ``dgesv``).  At
``K >= 128`` on CUDA the Cholesky is the blocked form whose diagonal
blocks run the hand-written kernel of ``csrc/chol_inv.cu``.

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) both
tables are row-sharded and each chunk's rows split over the ranks
(``parallel/shard_step.py::sharded_wmf_chunk``, the JAX package's
``shard_map`` branch): the Gramian is the local product all-reduced, a
chunk's positives come by an O(gathered rows) exchange and its solutions
by an all-gather of ``C x K``.

``fit(checkpoint_path=p)`` saves ``{"W", "H"}``, the JAX package's
schema, and ``resume=True`` continues from it, whatever row padding
(number of ranks, or the JAX package's devices) wrote it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import config
from ..ops.als import (build_chunks, place_device_chunks,
                       place_mesh_chunks, resolve_chol_solver,
                       wmf_chunk_solve, wmf_chunk_solve_woodbury)
from ..parallel.shard_step import sharded_gramian, sharded_wmf_chunk
from ..utils.checkpoint import resume_state
from .base import MFTrainerBase, PersistenceMixin, as_csr, padded_rows


def woodbury_max_p(num_components: int, weight: float, weight_decay: float,
                   solver: str) -> int:
    """Largest chunk pad ``P`` that routes to the Woodbury form, from
    ``CYMF_TPU_ALS_WOODBURY`` (auto|off|on) and the resolved ``solver``.

    ``auto`` routes at ``K >= 128``, ``weight > 1`` and
    ``weight_decay >= 1e-3`` (the explicit f32 inverse of ``A0`` loses
    ~cond(A0) eps digits).  Its cap is ``K/4`` against the blocked
    Cholesky forms (``cholesky_blocked``, ``cholesky_cuda``) and ``K``
    against the dense one, the JAX package's rule (`wmf.py:118-126`).
    """
    mode = os.environ.get("CYMF_TPU_ALS_WOODBURY", "auto")
    if mode not in ("auto", "off", "on"):
        raise ValueError("CYMF_TPU_ALS_WOODBURY must be auto|off|on")
    if mode == "on" and weight <= 1.0:
        raise ValueError(
            "CYMF_TPU_ALS_WOODBURY=on requires weight > 1 (the Woodbury "
            "capacitance divides by weight - 1)")
    if mode == "off" or weight <= 1.0:
        return 0
    if mode == "on":
        return 1 << 30
    if weight_decay < 1e-3 or num_components < 128:
        return 0
    if solver.startswith(("cholesky_blocked", "cholesky_cuda")):
        return num_components // 4
    return num_components


class WMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.WMF`` (`wmf.pyx:32-59`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU."""

    def __init__(self, num_components: int = 20, weight_decay: float = 0.01,
                 weight: float = 10.0, chunk_size: int = 2048,
                 solver: str = "cholesky", device=None):
        super().__init__(num_components, device=device)
        self.weight_decay = float(weight_decay)
        self.weight = float(weight)
        self.chunk_size = int(chunk_size)
        if solver not in ("cholesky", "lu"):
            raise ValueError("solver must be 'cholesky' or 'lu'")
        self.solver = solver

    @torch.no_grad()
    def fit(self, X, num_epochs: int = 5, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = True, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train; signature parity with `wmf.pyx`.  ``num_threads`` is
        accepted and ignored.

        After the fit: ``woodbury_max_p_`` (the routing cap),
        ``epoch_times_`` (seconds per epoch, synchronised) and
        ``chunks_`` (host ``build_s`` seconds, and per side ``"W"``/``"H"``
        the number of ``standard`` and ``woodbury`` chunks).
        ``checkpoint_path``, ``checkpoint_every`` and ``resume`` as
        ``BPR.fit``."""
        X = as_csr(X)
        mesh = self._mesh_device()
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()
        dev = self.device
        K = self.num_components
        # the solver and the Woodbury cap, once a fit
        solver_r = resolve_chol_solver(self.solver, K, dev)
        wb_max_p = woodbury_max_p(K, self.weight, self.weight_decay,
                                  solver_r)
        self.woodbury_max_p_ = wb_max_p

        U, I = X.shape
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)
        sharded = mesh.num_devices > 1
        # the tables' rows, padded to a multiple of the world size
        Up, Ip = mesh.pad_rows(U), mesh.pad_rows(I)

        t0 = time.perf_counter()
        Xt = X.T.tocsr()
        Xt.sort_indices()
        chunks = {"W": build_chunks(X, self.chunk_size, Up, num_components=K),
                  "H": build_chunks(Xt, self.chunk_size, Ip,
                                    num_components=K)}
        self.chunks_ = {"build_s": time.perf_counter() - t0}
        for side, cs in chunks.items():
            nw = sum(c.idx_pad.shape[1] <= wb_max_p for c in cs)
            self.chunks_[side] = {"standard": len(cs) - nw, "woodbury": nw}
        if sharded:
            user_chunks = place_mesh_chunks(chunks["W"], mesh)
            item_chunks = place_mesh_chunks(chunks["H"], mesh)
        else:
            user_chunks = place_device_chunks(chunks["W"], dev, U)
            item_chunks = place_device_chunks(chunks["H"], dev, I)
        self._samples_per_epoch = X.nnz

        # the whole (padded) tables on the host, or on the one device
        state, start_epoch = resume_state(
            checkpoint_path, resume,
            {"W": padded_rows(self.W, Up), "H": padded_rows(self.H, Ip)}
            if sharded else {"W": padded_rows(self.W, U).to(dev),
                             "H": padded_rows(self.H, I).to(dev)},
            {"W": U, "H": I})
        mesh.agree(start_epoch, "the checkpoint's epoch")
        if sharded:
            state = {k: mesh.put_table(v) for k, v in state.items()}
        self._state = state
        self._sharded_keys = frozenset(state) if sharded else frozenset()
        eye = torch.eye(K, dtype=config.param_dtype(), device=dev)
        wd, weight = self.weight_decay, self.weight

        def half_sweep(target_key: str, source_key: str, chunks):
            Y = self._state[source_key]
            # float32 under any param dtype (preferred_element_type in
            # JAX); wd * eye is in the param dtype
            A0 = sharded_gramian(mesh, Y, wd) if sharded \
                else Y.float().T @ Y.float() + wd * eye
            A0i = torch.linalg.inv_ex(A0)[0] if any(
                c.idx_pad.shape[1] <= wb_max_p for c in chunks) else None
            T = self._state[target_key]
            for ch in chunks:
                if sharded:
                    sharded_wmf_chunk(mesh, Y, T, A0, A0i, ch, weight=weight,
                                      solver=solver_r, wb_max_p=wb_max_p)
                    continue
                if ch.idx_pad.shape[1] <= wb_max_p:
                    x = wmf_chunk_solve_woodbury(Y, A0i, ch.idx_pad,
                                                 ch.valid, weight,
                                                 solver=solver_r)
                else:
                    x = wmf_chunk_solve(Y, A0, ch.idx_pad, ch.valid,
                                        weight, solver=solver_r)
                T.index_copy_(0, ch.rows, x.to(T.dtype))

        self.epoch_times_ = []

        def epoch_fn(epoch):
            t0 = time.perf_counter()
            half_sweep("W", "H", user_chunks)   # wmf.pyx:111
            half_sweep("H", "W", item_chunks)   # wmf.pyx:112
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(time.perf_counter() - t0)

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose, checkpoint_path, checkpoint_every,
                         start_epoch)
        self._drop_device_state()
