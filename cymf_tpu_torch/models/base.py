"""Shared trainer machinery: input coercion, init, early stopping,
persistence.  Port of `cymf_tpu/models/base.py`.

The sklearn-style contract of the reference trainers
(`cymf/bpr.pyx:50-68`): ``Model(...)`` holds
hyperparameters, ``fit(X, num_epochs, num_threads, valid_evaluator,
early_stopping, verbose)`` trains, the learned factors are numpy
``model.W`` / ``model.H`` and warm-start a later fit.  During ``fit`` the
live tables are tensors on the model's device in ``self._state``.  The
tables are training state, not layers, so nothing here is an
``nn.Module``.

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``), every
rank runs the same ``fit``; a sharded engine keeps only this rank's rows
of a table, and reading ``model.W`` / ``model.H`` during the fit gathers
them (``parallel.mesh.fetch_to_host``): a collective, which every rank
must make together.  The end of ``fit`` gathers once, on every rank, and
the tables are host-local after it.  A checkpoint is written by rank 0
from the gathered state while the others wait at a barrier, and a resume
reads the file on every rank; the early-stopping decision follows rank
0's validation score.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from .. import config
from ..parallel.mesh import (MeshContext, current_mesh, fetch_to_host,
                             host_array)


def as_csr(X) -> sparse.csr_matrix:
    """Input coercion per `cymf/bpr.pyx:81-87`."""
    if X is None:
        raise ValueError()
    if sparse.issparse(X):
        X = X.tocsr()
    elif isinstance(X, np.ndarray):
        X = sparse.csr_matrix(X)
    else:
        raise ValueError()
    X = X.astype(np.float64)
    X.sort_indices()
    return X


def uniform_init(shape, scale_div: float, low=-0.1, high=0.1,
                 seed: Optional[int] = None) -> np.ndarray:
    """U(low, high)/num_components init (`bpr.pyx:97-101`).

    The reference seeds numpy with 4321 immediately before drawing W (and
    draws H from the advanced state); callers pass ``seed=4321`` for W and
    ``seed=None`` for H to replicate the stream.
    """
    if seed is not None:
        np.random.seed(seed)
    return np.random.uniform(low=low, high=high, size=shape) / scale_div


class EarlyStopper:
    """Exact early-stopping state machine of the reference trainers.

    From `cymf/bpr.pyx:173-183`: track best validation DCG@5;
    on a non-improving epoch increment a counter, breaking once the counter
    exceeds 10; on improvement reset the counter and snapshot best weights.
    Best weights are restored only when ``early_stopping`` is on
    (`bpr.pyx:188-190`).
    """

    def __init__(self, early_stopping: bool):
        self.early_stopping = early_stopping
        self.best_dcg = -np.inf
        self.count = 0
        self.best_snapshot = None

    def update(self, dcg: float, snapshot_fn) -> bool:
        """Returns True if training should stop now."""
        if self.best_dcg > dcg:
            if self.early_stopping and self.count > 10:
                return True
            if self.early_stopping:
                self.count += 1
        else:
            self.count = 0
            self.best_dcg = dcg
            if self.early_stopping:
                self.best_snapshot = snapshot_fn()
        return False


def padded_rows(a, rows: int) -> torch.Tensor:
    """``a`` (an array or a tensor) with zero rows appended up to
    ``rows``, as a CPU tensor in :func:`cymf_tpu_torch.config.param_dtype`
    (as the JAX package's ``_pad_table`` places tables): a whole table
    padded to a mesh's row count, for ``MeshContext.put_table``."""
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a.cpu(),
                        dtype=config.param_dtype())
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


class MFTrainerBase:
    """Base for the two-table (W: users, H: items) trainers.

    ``model.W`` / ``model.H`` are numpy copies of the learned factors
    (`bpr.pyx:46-47`); during ``fit`` they are read from the device
    tables on access (gathered from the ranks where an engine shards
    them: see the module docstring).
    """

    # the keys of ``_state`` whose tensors are this rank's row shard of a
    # table (set by a sharded engine; read back through fetch_to_host)
    _sharded_keys: frozenset = frozenset()

    def __init__(self, num_components: int, device=None):
        self.num_components = int(num_components)
        self._device_arg = device
        self.device = torch.device(device) if device is not None \
            else config.default_device()
        self._W_host: Optional[np.ndarray] = None
        self._H_host: Optional[np.ndarray] = None
        self._state = None  # dict with device tensors "W", "H" during fit
        self._num_users = 0
        self._num_items = 0
        self.valid_evaluator = None
        self.valid_dcg = -np.inf
        self.early_stopping = False

    def _fetch(self, key: str, n: int) -> np.ndarray:
        """First ``n`` rows of the live table ``_state[key]`` on the host:
        gathered from the ranks if it is sharded (a collective)."""
        if key in self._sharded_keys:
            return fetch_to_host(self._state[key], self.mesh)[:n]
        return host_array(self._state[key][:n])

    @property
    def W(self):
        if self._state is not None:
            return self._fetch("W", self._num_users)
        return self._W_host

    @W.setter
    def W(self, value):
        self._drop_device_state()
        self._W_host = None if value is None else np.asarray(value)

    @property
    def H(self):
        if self._state is not None:
            return self._fetch("H", self._num_items)
        return self._H_host

    @H.setter
    def H(self, value):
        self._drop_device_state()
        self._H_host = None if value is None else np.asarray(value)

    def _drop_device_state(self):
        """Move the learned tables to host and drop device state (after a
        fit, or when a table is set by hand: both host copies are kept
        first so the untouched table survives)."""
        if self._state is not None:
            self._W_host = self._fetch("W", self._num_users)
            self._H_host = self._fetch("H", self._num_items)
            self._state = None
            self._sharded_keys = frozenset()

    # -- mesh ---------------------------------------------------------------
    @property
    def mesh(self) -> MeshContext:
        return current_mesh()

    def _mesh_device(self) -> MeshContext:
        """The fit's mesh; sets ``device`` to where the fit runs
        (:meth:`MeshContext.resolve_device`: under more than one rank, the
        rank's device)."""
        mesh = self.mesh
        self.device = mesh.resolve_device(self._device_arg)
        return mesh

    def _pad_table(self, T: np.ndarray) -> torch.Tensor:
        """Pad rows to a mesh-divisible count; this rank's row shard."""
        mesh = self.mesh
        return mesh.put_table(padded_rows(T, mesh.pad_rows(T.shape[0])))

    def _checkpoint_state(self):
        """The state a checkpoint holds: ``_state``, with each sharded
        leaf gathered from the ranks (a collective)."""
        if not self._sharded_keys:
            return self._state

        def gather(v):
            if isinstance(v, dict):
                return {k: gather(x) for k, x in v.items()}
            return fetch_to_host(v, self.mesh)

        return {k: gather(v) if k in self._sharded_keys else v
                for k, v in self._state.items()}

    def _ensure_tables(self, num_rows_w: int, num_rows_h: int) -> None:
        """Lazy init W,H ~ U(-0.1, 0.1)/K with np.random.seed(4321) before W
        only (`bpr.pyx:97-101`); existing tables are kept (warm start)."""
        K = self.num_components
        if self.W is None:
            self.W = uniform_init((num_rows_w, K), K, seed=4321)
        if self.H is None:
            self.H = uniform_init((num_rows_h, K), K)

    def _run_epochs(self, num_epochs: int, epoch_fn, snapshot_fn, restore_fn,
                    verbose: bool, checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 1, start_epoch: int = 0):
        """Run ``epoch_fn(epoch)`` for epochs ``start_epoch`` to
        ``num_epochs - 1`` with validation and early stopping.

        Mirrors the loop at `bpr.pyx:160-190`: per-epoch validation via
        ``valid_evaluator.evaluate(W, H)["DCG@5"]``, stop after >10
        consecutive non-improving epochs, restore the best weights at the
        end.  ``verbose`` prints one progress line per epoch.

        When ``checkpoint_path`` is set, ``self._state`` is written after
        every epoch ``e`` with ``(e + 1) % checkpoint_every == 0``
        (atomic npz, ``cymf_tpu_torch.utils.checkpoint``): the copy to the
        host blocks the loop, the disk write runs on a thread and is
        flushed before this returns.  ``checkpoint_s_`` holds each save's
        blocking seconds.
        """
        from ..utils.checkpoint import AsyncCheckpointer
        from ..utils.profiling import Throughput
        mesh = self.mesh
        stopper = EarlyStopper(self.early_stopping)
        ckpt = AsyncCheckpointer() if checkpoint_path else None
        self.checkpoint_s_ = []
        valid_dcg = None
        thr = Throughput()
        samples_per_epoch = getattr(self, "_samples_per_epoch", 0)
        thr.tick(0)
        for epoch in range(start_epoch, num_epochs):
            epoch_fn(epoch)
            thr.tick(samples_per_epoch)
            if ckpt and (epoch + 1) % checkpoint_every == 0:
                t0 = time.perf_counter()
                state = self._checkpoint_state()
                if mesh.rank == 0:
                    ckpt.save(checkpoint_path, state, epoch)
                self.checkpoint_s_.append(time.perf_counter() - t0)
            if self.valid_evaluator:
                # rank 0's score decides, so every rank stops together
                valid_dcg = mesh.broadcast_float(self.valid_evaluator.evaluate(
                    self.W, self.H)["DCG@5"])
                if stopper.update(valid_dcg, snapshot_fn):
                    break
                self.valid_dcg = stopper.best_dcg
            if verbose:
                print(f"EPOCH={epoch + 1:{len(str(num_epochs))}}"
                      + (f", DCG@5={np.round(valid_dcg, 3)}"
                         if self.valid_evaluator else "")
                      + (f", {thr.format()}" if samples_per_epoch
                         and thr.rate else ""), flush=True)
        if ckpt:
            ckpt.wait()
            # the file is whole before any rank returns (or resumes)
            mesh.barrier()
        if self.valid_evaluator and self.early_stopping \
                and stopper.best_snapshot is not None:
            restore_fn(stopper.best_snapshot)

    # epoch e+1's host prep runs on a worker thread while epoch e runs;
    # the tables are the same bits either way (a test turns it off)
    _overlap_prep = True

    def _run_device_epochs(self, num_epochs: int, verbose: bool, prep, run,
                           publish, checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 1,
                           start_epoch: int = 0) -> None:
        """The fused engines' epoch loop: per epoch the host prep
        ``prep(epoch)`` (a tuple of streams; ``prep`` None: the epoch has
        none), then ``run(epoch, *streams)``, the uploads and steps, which
        returns the epoch's loss, then ``publish()`` of the live tables;
        validation, early stopping and the best-epoch restore as
        :meth:`_run_epochs` runs them, ``last_loss`` from the last epoch.

        Epoch e+1's prep runs on a worker thread while epoch e is queued
        and runs on the device (the native prep releases the interpreter
        lock; each epoch's streams depend on its seed and epoch alone).  A
        fit that stops early drops the epoch prepared last.  A resumed fit
        (``start_epoch`` > 0) runs and prepares its epochs from
        ``start_epoch`` on; the checkpoint arguments go to
        :meth:`_run_epochs`.  ``epoch_times_`` holds per epoch that ran
        the host seconds of its prep
        (``prep_s``, where there is one) and the seconds of its device
        work (``device_s``: between CUDA events around ``run`` on the
        card, the host clock on the CPU)."""
        dev = self.device
        publish()
        self.epoch_times_ = []
        loss = None
        ahead = {}
        pool = ThreadPoolExecutor(max_workers=1) \
            if prep is not None and self._overlap_prep else None

        def timed_prep(epoch):
            t0 = time.perf_counter()
            streams = prep(epoch)
            return streams, time.perf_counter() - t0

        def epoch_fn(epoch):
            nonlocal loss
            times, streams = {}, ()
            if prep is not None:
                fut = ahead.pop(epoch, None)
                streams, times["prep_s"] = fut.result() if fut is not None \
                    else timed_prep(epoch)
                if pool is not None and epoch + 1 < num_epochs:
                    ahead[epoch + 1] = pool.submit(timed_prep, epoch + 1)
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record(torch.cuda.current_stream(dev))
                loss = run(epoch, *streams)
                ev[1].record(torch.cuda.current_stream(dev))
                ev[1].synchronize()
                times["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3
            else:
                t0 = time.perf_counter()
                loss = run(epoch, *streams)
                times["device_s"] = time.perf_counter() - t0
            self.epoch_times_.append(times)
            publish()

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        try:
            self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                             verbose, checkpoint_path, checkpoint_every,
                             start_epoch)
        finally:
            if pool is not None:
                # an epoch that early stopping dropped: wait for its prep,
                # whose streams go unused
                for fut in ahead.values():
                    if not fut.cancel():
                        fut.exception()
                pool.shutdown()
        if loss is not None:
            self.last_loss = float(loss)
        self._drop_device_state()


def _model_to_arrays(model) -> dict:
    arrays = {"W": model.W, "H": model.H,
              "num_components": np.asarray(model.num_components)}
    for name in ("learning_rate", "weight_decay", "weight", "clip_value",
                 "lam_y"):
        if hasattr(model, name):
            arrays[f"hyper_{name}"] = np.asarray(getattr(model, name))
    return arrays


class PersistenceMixin:
    """``model.save(path)`` / ``Model.load(path)``: learned factors and
    hyperparameters as one npz, in the JAX package's format, so either
    package loads a model the other saved."""

    def save(self, path: str) -> None:
        if self.W is None or self.H is None:
            raise ValueError("model has no learned factors to save")
        d = _model_to_arrays(self)
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        np.savez(path, **d)

    @classmethod
    def load(cls, path: str, device=None):
        with np.load(path) as z:
            kwargs = {"num_components": int(z["num_components"])}
            for k in z.files:
                if k.startswith("hyper_"):
                    kwargs[k[len("hyper_"):]] = float(z[k])
            model = cls(**kwargs, device=device)
            model.W = z["W"]
            model.H = z["H"]
            model._num_users = z["W"].shape[0]
            model._num_items = z["H"].shape[0]
        return model
