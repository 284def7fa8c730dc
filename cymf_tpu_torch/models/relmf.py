"""Relevance Matrix Factorization (Saito et al. 2019) — PyTorch trainer.

Behavioural spec from `cymf/relmf.pyx` + `model.pyx:89-142`: each epoch
draws ``N = U * I`` uniform random (user, item) cells, positives and
negatives, and descends the propensity-clipped pointwise loss

    w = r / max(p_i, M)                      (clip value M)
    L = w (1 - s)^2 + (1 - w) s^2 + wd (|w_u|^2 + |h_i|^2),   s = w_u . h_i

with gradients as `model.pyx:130-139` (weight decay ADDED, the opposite
sign convention to BPR).  Propensities
``p_i = max(mean_u X[:, i] / max_mean, 1e-5)^0.5`` (`relmf.pyx:88`).

Port of `cymf_tpu/models/relmf.py` on its single-device packed engine
(``_fit_packed_relmf``, `ops/relmf_epoch.py`): a lane-packed user table,
a logical item table, the GloVe sample phase with theta on the
decoration lane and the windowed accumulations.  Stream prep runs on the
tables' device by default (``CYMF_TPU_RELMF_PREP=device``: draws from a
``torch.Generator``, hash-set labels, sorts and windows on the card), or
on the host (``CYMF_TPU_RELMF_PREP=host``: the JAX package's native
stream, or its numpy stream under ``CYMF_TPU_PREP=numpy``, capped at
:data:`HOST_PREP_MAX_CELLS` cells an epoch, each epoch's prep beside the
previous epoch's device work; device prep has no cap).

``engine="pallas"`` runs the sequential small-catalog engine
(``_fit_pallas``, `ops/pallas_engine.py`): every epoch's ``U * I`` cells
drawn on the host from ``default_rng(seed)`` as the JAX package draws
them, labels from X's values (a non-binary X is taken), and per-sample
updates in groups of 8, one kernel launch an epoch.

The portable batch engine (``_fit_batch``, :func:`_relmf_epoch`) takes
``packed="off"`` and, under ``"auto"``, what the packed engine cannot: a
non-binary ``X`` (labels from ``ops/segment.py::csr_lookup``),
``num_components > 126``, and host-prep epochs above the cap.  Each step
draws ``B`` cells on the tables' device from one ``torch.Generator`` an
epoch (:func:`_draw_cells`, the draws of ``ops/relmf_epoch.py::
draw_cells``) and makes one synchronous update per table through
:mod:`cymf_tpu_torch.optim`, dense or sparse.  Left behind: the JAX
package's chunking of an epoch into scans of at most 2048 steps from a
traced ``step0``, a relay workaround (ROADMAP.md, "Leave behind").

One deliberate difference: the JAX package takes the packed engine on a
TPU only; the port under ``"auto"`` takes it wherever it fits, on the card
as on the TPU, and on the CPU too, whose plain forms the CPU tests hold
against the card's kernels.

Checkpoints hold the JAX package's schemas (``{"W", "H", "ow", "oh"}``
batch, ``{"W", "H", "owp", "ohp"}`` packed) and either engine resumes
either's, of either package (the layouts of `models/sgd.py`, BPR's too);
the sequential engine refuses them, as in the JAX package.

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) the
routing is the JAX package's (`cymf_tpu/models/relmf.py:190-206`):
``packed="on"`` raises ``ValueError`` and ``"auto"`` takes the batch
engine's sharded form (``_fit_batch_sharded``,
``parallel/shard_step.py::sharded_relmf_epoch``): both tables row-sharded,
the batch padded to a multiple of the world size, each step's whole
batch drawn on every rank and split between them, so the cell stream is
the single-device engine's at the same batch.  ``engine="pallas"`` runs
the sequential engine on each rank's device, as the JAX package runs it
on one device of its mesh.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from .. import config
from ..ops import packed as pk
from ..ops import pallas_engine as pe
from ..ops.hashset import hashset_contains
from ..ops.packed_epoch import (make_packed_optimizer, make_reject_filter,
                                prep_backend, row_dot)
from ..ops.relmf_epoch import (packed_relmf_epoch, packed_relmf_epoch_device,
                               prep_relmf_epoch, supports_packed_relmf)
from ..ops.segment import csr_lookup
from ..optim import choose_update_mode, make_optimizer
from ..parallel.shard_step import sharded_relmf_epoch
from ..utils.profiling import spanned, upload_array
from .base import MFTrainerBase, PersistenceMixin, as_csr
from .sgd import Layout, epoch_generator, pair_hashset, positive_keys

# host prep holds an epoch's cells as int64 draws and int32 streams: cap
# it at the JAX package's default of 2^27 cells (about 3 GiB of prep)
HOST_PREP_MAX_CELLS = 1 << 27


def _draw_cells(gen: torch.Generator, B: int, num_users: int,
                num_items: int, device):
    """One step's ``B`` cells on ``device`` from ``gen``: int32 users, then
    items, each uniform (the draws of ``ops/relmf_epoch.py::draw_cells``):
    the batch engine's only draw."""
    u = torch.randint(0, num_users, (B,), generator=gen, device=device,
                      dtype=torch.int32)
    i = torch.randint(0, num_items, (B,), generator=gen, device=device,
                      dtype=torch.int32)
    return u, i


def _relmf_epoch(W, H, opt_w, opt_h, label_src, props, gen, *, optimizer,
                 weight_decay: float, clip_value: float, num_users: int,
                 num_items: int, num_steps: int, batch_size: int,
                 update_mode: str = "dense", binary_labels: bool = False
                 ) -> torch.Tensor:
    """One epoch of the batch engine, ``num_steps`` steps of
    ``batch_size`` drawn cells, as ``cymf_tpu.models.relmf._relmf_epoch``
    (one whole epoch, no chunks).  ``label_src`` is the pair hash set
    (``binary_labels``) or ``(indptr, indices, data)`` of ``X``'s CSR;
    ``props`` the ``(I, 1)`` propensity column.  Updates ``W``, ``H`` and
    the optimizer states IN PLACE; returns the SUM of the per-sample
    losses (callers normalize over the epoch)."""
    dev = W.device
    weight_decay = config.scalar(weight_decay, W.dtype)
    clip_value = config.scalar(clip_value, W.dtype)
    loss_acc = torch.zeros((), dtype=W.dtype, device=dev)
    for _ in range(num_steps):
        u, i = _draw_cells(gen, batch_size, num_users, num_items, dev)
        if binary_labels:
            r = hashset_contains(label_src, u, i).to(W.dtype)
        else:
            r = csr_lookup(*label_src, u, i)[1]
        p = props.index_select(0, i)[:, 0]
        w = r / torch.clamp(p, min=clip_value)
        wu, hi = W.index_select(0, u), H.index_select(0, i)
        s = row_dot(wu, hi, keepdim=True)
        wcol = w[:, None]
        # gradients per model.pyx:130-139 (decay ADDED, reference sign quirk)
        g_w = -(wcol * (1.0 - s) * hi + (1.0 - wcol) * (0.0 - s) * hi) \
            + weight_decay * wu
        g_h = -(wcol * (1.0 - s) * wu + (1.0 - wcol) * (0.0 - s) * wu) \
            + weight_decay * hi
        l2 = row_dot(wu, wu) + row_dot(hi, hi)
        loss = (w * torch.square(1.0 - s[:, 0])
                + (1.0 - w) * torch.square(s[:, 0]) + weight_decay * l2)
        if update_mode == "dense":
            optimizer.update_dense(W, opt_w, [(u, g_w)])
            optimizer.update_dense(H, opt_h, [(i, g_h)])
        else:
            optimizer.update_rows(W, opt_w, u, g_w)
            optimizer.update_rows(H, opt_h, i, g_h)
        loss_acc += torch.sum(loss)
    return loss_acc


class RelMF(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.RelMF`` (`relmf.pyx:37-67`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU."""

    def __init__(self, num_components: int = 20, clip_value: float = 0.1,
                 learning_rate: float = 0.001, optimizer: str = "adam",
                 weight_decay: float = 0.01, batch_size: int = 8192,
                 update_mode: str = "auto", engine: str = "xla",
                 packed: str = "auto", device=None):
        """Arguments as ``cymf_tpu.RelMF``.  Under ``engine="xla"``,
        ``packed="on"`` runs the packed engine, ``"off"`` the batch
        engine, and ``"auto"`` the packed engine where it fits
        (:meth:`_packed_engine`).  ``update_mode`` picks the batch
        engine's update; as in the JAX package's packed and sequential
        engines, it has no effect on them."""
        super().__init__(num_components, device=device)
        if engine not in ("xla", "pallas"):
            raise ValueError("engine must be 'xla' or 'pallas'")
        self.engine = engine
        self.clip_value = float(clip_value)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.weight_decay = float(weight_decay)
        self.batch_size = int(batch_size)
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError("update_mode must be auto|dense|sparse")
        self.update_mode = update_mode
        if self.optimizer not in ("sgd", "adagrad", "adam"):
            raise Exception(f"{self.optimizer} is invalid.")
        if packed not in ("auto", "on", "off"):
            raise ValueError("packed must be auto|on|off")
        self.packed = packed
        if packed == "on" and engine != "xla":
            raise ValueError("packed='on' requires engine='xla' "
                             f"(got engine={engine!r})")

    @staticmethod
    def _packed_prep_mode() -> str:
        """``"device"`` (default): draws, labels, sorts and windows run on
        the tables' device, no per-epoch host streams and no epoch-size
        cap.  ``"host"`` (``CYMF_TPU_RELMF_PREP=host``): the per-epoch
        host prep of the JAX package, native or numpy
        (``packed_epoch.prep_backend``)."""
        mode = os.environ.get("CYMF_TPU_RELMF_PREP", "device").lower()
        if mode not in ("device", "host"):
            raise ValueError("CYMF_TPU_RELMF_PREP must be device|host")
        return mode

    def _packed_engine(self, binary: bool, cells: int,
                       num_devices: int = 1) -> bool:
        """True if the packed engine takes this fit: not ``packed="off"``,
        a world of one rank, a binarized matrix, a packable payload and,
        under host prep, at most :data:`HOST_PREP_MAX_CELLS` cells an
        epoch (device prep has no cap).  Where it does not fit,
        ``packed="on"`` raises ``ValueError`` as the JAX package does, and
        ``"auto"`` takes the batch engine (`cymf_tpu/models/relmf.py:
        197-209`, whose TPU the card and, deliberately, the CPU stand in
        for)."""
        if self.packed == "off":
            return False
        capped = (self._packed_prep_mode() == "host"
                  and cells > HOST_PREP_MAX_CELLS)
        if binary and supports_packed_relmf(self.num_components) \
                and not capped and num_devices == 1:
            return True
        if self.packed == "on":
            raise ValueError(
                "packed='on' requires a single-device mesh, a binarized "
                "matrix, num_components <= 126, and (with "
                "CYMF_TPU_RELMF_PREP=host) at most "
                f"{HOST_PREP_MAX_CELLS} cells an epoch (got {cells} cells "
                f"an epoch on {num_devices} ranks; device prep has no cap)")
        return False

    @torch.no_grad()
    @spanned("relmf.fit")
    def fit(self, X, num_epochs: int = 10, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = False, seed: int = 1234, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train; signature parity with `relmf.pyx:67`.

        ``num_threads`` is accepted and ignored; ``seed`` drives the cell
        draws.  After the fit, ``epoch_times_`` holds per epoch the
        device seconds (``device_s``: the epoch's uploads and steps) and,
        under host prep or ``engine="pallas"``, the host prep seconds
        (``prep_s``; host prep runs beside the previous epoch's device
        work).  ``checkpoint_path``, ``checkpoint_every`` and ``resume``
        as ``BPR.fit``; ``engine="pallas"`` refuses checkpoints."""
        X = as_csr(X)
        n = self._mesh_device().num_devices
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()

        U, I = X.shape
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)
        # propensities per relmf.pyx:88 (column means of the full matrix)
        col_mean = np.asarray(X.mean(axis=0)).flatten()
        props = np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5
        if self.engine == "pallas":
            if checkpoint_path is not None:
                raise NotImplementedError(
                    "checkpointing is only supported with engine='xla'")
            self._samples_per_epoch = U * I
            self._fit_pallas(X, props, num_epochs, verbose, seed)
            return

        binary = bool(X.nnz == 0 or np.all(X.data == 1.0))
        B = -(-self.batch_size // 1024) * 1024
        S = max(1, -(-(U * I) // B))      # N = U*I samples per epoch
        self.packed_engine_ = self._packed_engine(binary, S * B, n)
        ckpt = (checkpoint_path, checkpoint_every, resume)
        if not self.packed_engine_:
            fit = self._fit_batch_sharded if n > 1 else self._fit_batch
            fit(X, props, binary, num_epochs, verbose, seed, *ckpt)
            return
        self._samples_per_epoch = S * B
        self._fit_packed_relmf(X, props, B, S, num_epochs, verbose, seed,
                               *ckpt)

    def _fit_batch(self, X, props, binary, num_epochs, verbose, seed,
                   checkpoint_path, checkpoint_every, resume):
        """The portable batch engine (:func:`_relmf_epoch`), as the
        single-device branch of ``cymf_tpu.RelMF.fit``: ``B = batch_size``,
        ``ceil(U * I / B)`` steps an epoch, labels from the pair hash set
        (binary ``X``) or ``X``'s CSR, ``mode`` from ``2 * B`` rows against
        the tables', one ``torch.Generator`` an epoch."""
        dev = self.device
        U, I = X.shape
        B = self.batch_size
        num_steps = max(1, -(-(U * I) // B))  # N = U*I samples an epoch
        self._samples_per_epoch = num_steps * B

        label_src = self._labels(X, binary)
        dtype = config.param_dtype()
        props_d = upload_array(props[:, None], dev, dtype)
        self.update_mode_ = choose_update_mode(self.update_mode, 2 * B,
                                               U + I)
        opt = make_optimizer(self.optimizer, self.learning_rate)
        layout = Layout("logical", U, I, self.num_components)
        W, H, ow, oh, start_epoch = layout.state(self, opt, checkpoint_path,
                                                 resume)
        # a float (U * I may pass int32), in the param dtype as in JAX
        total = config.scalar(float(num_steps * B), dtype)

        def run(epoch):
            return _relmf_epoch(
                W, H, ow, oh, label_src, props_d,
                epoch_generator(seed, epoch, dev), optimizer=opt,
                weight_decay=self.weight_decay, clip_value=self.clip_value,
                num_users=U, num_items=I, num_steps=num_steps, batch_size=B,
                update_mode=self.update_mode_,
                binary_labels=binary) / total

        self._run_device_epochs(num_epochs, verbose, None, run,
                                layout.publish, checkpoint_path,
                                checkpoint_every, start_epoch)

    def _labels(self, X, binary: bool):
        """Where the batch engines read their labels, on the tables'
        device: the pair hash set of a binary ``X``, else its CSR."""
        dev = self.device
        if binary:
            return pair_hashset(X, dev)
        return (upload_array(X.indptr, dev, torch.int64),
                upload_array(X.indices, dev, torch.int32),
                upload_array(X.data, dev, config.param_dtype()))

    def _fit_batch_sharded(self, X, props, binary, num_epochs, verbose,
                           seed, checkpoint_path, checkpoint_every, resume):
        """The batch engine on a mesh (:func:`~cymf_tpu_torch.parallel.
        shard_step.sharded_relmf_epoch`), as the mesh branch of
        ``cymf_tpu.RelMF.fit``: W, H and their Adam (or other) states
        row-sharded over the ranks (rows padded by ``mesh.pad_rows``),
        ``B = mesh.pad_rows(batch_size)`` (with the JAX package's warning
        when that pads), ``ceil(U * I / B)`` steps an epoch, labels and
        propensities whole on every rank, dense masked updates."""
        mesh = self.mesh
        dev = self.device
        U, I = X.shape
        B = mesh.pad_rows(self.batch_size)
        if B != self.batch_size:
            warnings.warn(
                f"batch_size={self.batch_size} padded to {B} (multiple of "
                f"{mesh.num_devices} devices): the drawn cell stream and "
                "samples_per_epoch differ from a device count where no "
                "padding is needed", stacklevel=3)
        # python ints: ML-20M's 3.7e9 cells an epoch overflow int32
        num_steps = max(1, -(-(U * I) // B))
        self._samples_per_epoch = num_steps * B
        self.update_mode_ = "dense"
        label_src = self._labels(X, binary)
        dtype = config.param_dtype()
        props_d = upload_array(props[:, None], dev, dtype)
        opt = make_optimizer(self.optimizer, self.learning_rate)
        n = mesh.num_devices
        layout = Layout("logical", U, I, self.num_components, n, n,
                        shard=(True, True))
        W, H, ow, oh, start_epoch = layout.state(self, opt, checkpoint_path,
                                                 resume)
        total = config.scalar(float(num_steps * B), dtype)

        def run(epoch):
            return sharded_relmf_epoch(
                mesh, W, H, ow, oh, label_src, props_d,
                epoch_generator(seed, epoch, dev), optimizer=opt,
                weight_decay=self.weight_decay, clip_value=self.clip_value,
                num_users=U, num_items=I, num_steps=num_steps, batch_size=B,
                binary=binary, draw=_draw_cells) / total

        self._run_device_epochs(num_epochs, verbose, None, run,
                                layout.publish, checkpoint_path,
                                checkpoint_every, start_epoch)

    def _fit_packed_relmf(self, X, props, B, S, num_epochs, verbose, seed,
                          checkpoint_path, checkpoint_every, resume):
        """Packed fused engine (`ops/relmf_epoch.py`) with device or host
        stream prep."""
        dev = self.device
        U, I = X.shape
        K = self.num_components
        wrows_w, wrows_h = 256, 256
        rw = pk.packed_rows(U, K, multiple=wrows_w)
        rh = pk.logical_rows(I, multiple=wrows_h)
        prep_mode = self._packed_prep_mode()
        self.prep_backend_ = "device-torch" if prep_mode == "device" \
            else prep_backend()
        invp = np.zeros((rh, 1), np.float32)
        invp[:I, 0] = 1.0 / np.maximum(props, self.clip_value)
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        layout = Layout("packed", U, I, K, wrows_w, wrows_h)
        # a checkpoint holds Hp[:, :K]: lane K comes back zero
        Wp, Hp, ow, oh, start_epoch = layout.state(self, opt,
                                                   checkpoint_path, resume)
        # a float: ML-20M's 3.7e9 cells an epoch overflow int32
        n_valid = float(S) * B
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows_w=wrows_w, wrows_h=wrows_h)

        if prep_mode == "device":
            # device prep reads 1/max(p_i, M) from lane K of Hp (the item
            # gather brings it along); gradients are payload-masked, so
            # every optimizer pass leaves it as it is
            Hp[:, K] = upload_array(invp[:, 0], dev)
            hs = pair_hashset(X, dev)

            def run(epoch):
                return packed_relmf_epoch_device(
                    Wp, Hp, ow, oh, hs, epoch_generator(seed, epoch, dev), S,
                    n_valid, B=B, num_users=U, num_items=I, **kw)

            self._run_device_epochs(num_epochs, verbose, None, run,
                                    layout.publish, checkpoint_path,
                                    checkpoint_every, start_epoch)
            return

        pos_keys = positive_keys(X)
        key_filter = make_reject_filter(pos_keys, U, I)
        invp_d = upload_array(invp, dev)

        def prep(epoch):
            return prep_relmf_epoch(seed, epoch, S, B, U, I, K, rw, rh,
                                    wrows_w, wrows_h, pos_keys,
                                    key_filter=key_filter)

        def run(epoch, u2, i2, lab, winw, si, rowsi, wini):
            return packed_relmf_epoch(
                Wp, Hp, ow, oh, *(upload_array(a, dev) for a in (
                    u2, i2, lab, si, rowsi, wini, winw)), invp_d, n_valid,
                **kw)

        self._run_device_epochs(num_epochs, verbose, prep, run,
                                layout.publish, checkpoint_path,
                                checkpoint_every, start_epoch)

    def _fit_pallas(self, X, props, num_epochs, verbose, seed,
                    chunk: int = 4096, group: int = 8):
        """Sequential per-cell training (`ops/pallas_engine.py`), as
        ``cymf_tpu.RelMF._fit_pallas``: each epoch draws ``u`` then ``i``
        over ``Np`` cells (``U * I`` padded to whole chunks) from one
        ``default_rng(seed)`` and looks the labels up in X's sorted keys;
        ``w = r / max(p_i, M)``, the mask covers the padding only."""
        U, I = X.shape
        if not pe.fits_vmem(U + I, self.optimizer):
            raise ValueError(
                "tables + optimizer state exceed the sequential engine's "
                "budget (the JAX package's VMEM gate); use engine='xla' for "
                "catalogs of this size")
        dev = self.device
        K = self.num_components
        N = U * I  # cells per epoch (relmf.pyx:128)
        chunk = max(group, (min(chunk, N) // group) * group)
        S = max(1, -(-N // chunk))
        Np = S * chunk
        clipped = np.maximum(props, self.clip_value)
        rng = np.random.default_rng(seed)
        keys = positive_keys(X)
        order = np.argsort(keys)
        pos_keys, pos_vals = keys[order], X.data[order].astype(np.float32)

        def put(a):
            return upload_array(a.reshape(S, 1, chunk), dev)

        Wp = pe.pack_table(self.W, self.optimizer, dev)
        Hp = pe.pack_table(self.H, self.optimizer, dev)
        self._state = {"W": pe.unpack_table(Wp, K),
                       "H": pe.unpack_table(Hp, K)}
        self.prep_backend_ = "numpy"
        self.last_loss = None
        self.epoch_times_ = []
        mask = put(np.arange(Np) < N).to(torch.int32)
        loss = None

        def epoch_fn(epoch):
            nonlocal loss
            t0 = time.perf_counter()
            u = rng.integers(0, U, Np).astype(np.int32)
            i = rng.integers(0, I, Np).astype(np.int32)
            # the label r = X[u, i] by a sorted-key lookup
            q = u.astype(np.int64) * I + i
            if len(pos_keys):
                pos = np.minimum(np.searchsorted(pos_keys, q),
                                 len(pos_keys) - 1)
                r = np.where(pos_keys[pos] == q, pos_vals[pos], 0.0)
            else:
                r = np.zeros(Np, np.float32)
            w = (r / clipped[i]).astype(np.float32)
            streams = [put(a) for a in (u, i, w)]
            t1 = time.perf_counter()
            loss = pe.relmf_pallas_epoch(
                Wp, Hp, *streams, mask, optimizer=self.optimizer,
                lr=self.learning_rate, wd=self.weight_decay, group=group)[2]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append({"prep_s": t1 - t0,
                                      "device_s": time.perf_counter() - t1})

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose)
        if loss is not None:
            self.last_loss = float(loss / max(N, 1))     # float32, as JAX
        self._drop_device_state()
