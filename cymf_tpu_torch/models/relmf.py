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
on the host (``CYMF_TPU_RELMF_PREP=host``: the JAX package's numpy
stream, capped at :data:`HOST_PREP_MAX_CELLS` cells an epoch; device prep
has no cap).

``engine="pallas"`` runs the sequential small-catalog engine
(``_fit_pallas``, `ops/pallas_engine.py`): every epoch's ``U * I`` cells
drawn on the host from ``default_rng(seed)`` as the JAX package draws
them, labels from X's values (a non-binary X is taken), and per-sample
updates in groups of 8, one kernel launch an epoch.

One deliberate difference: ``packed="auto"`` picks the packed engine on
any device, since it is the port's only XLA engine; the JAX package picks
it on a TPU only.  Not ported yet (ROADMAP.md, queue 1): the in-jit engine
(``packed="off"`` under ``engine="xla"``, and what only it takes there: a
non-binary ``X``, ``num_components > 126``, host-prep epochs above the
cap), checkpoints and the multi-device engines.  Each raises
``NotImplementedError``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops import packed as pk
from ..ops import pallas_engine as pe
from ..ops.hashset import build_pair_hashset, to_device
from ..ops.packed_epoch import make_packed_optimizer, unpack_device
from ..ops.relmf_epoch import (epoch_generator, packed_relmf_epoch,
                               packed_relmf_epoch_device, prep_relmf_epoch,
                               supports_packed_relmf)
from .base import MFTrainerBase, PersistenceMixin, as_csr

_LATER = "is not ported to cymf_tpu_torch yet (ROADMAP.md, queue 1)"
# host prep holds an epoch's cells as int64 draws and int32 streams: cap
# it at the JAX package's default of 2^27 cells (about 3 GiB of prep)
HOST_PREP_MAX_CELLS = 1 << 27


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
        ``packed="auto"`` and ``"on"`` both run the packed engine;
        ``update_mode`` is validated and, as in the JAX package's packed
        and sequential engines, has no effect."""
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
        if engine == "xla" and packed == "off":
            raise NotImplementedError(f"packed='off' (the in-jit engine) "
                                      f"{_LATER}")

    @staticmethod
    def _packed_prep_mode() -> str:
        """``"device"`` (default): draws, labels, sorts and windows run on
        the tables' device, no per-epoch host streams and no epoch-size
        cap.  ``"host"`` (``CYMF_TPU_RELMF_PREP=host``): the per-epoch
        numpy prep of the JAX package."""
        mode = os.environ.get("CYMF_TPU_RELMF_PREP", "device").lower()
        if mode not in ("device", "host"):
            raise ValueError("CYMF_TPU_RELMF_PREP must be device|host")
        return mode

    def _packed_engine(self, binary: bool, cells: int) -> bool:
        """True if the packed engine takes this fit: a binarized matrix, a
        packable payload and, under host prep, at most
        :data:`HOST_PREP_MAX_CELLS` cells an epoch (device prep has no
        cap).  Otherwise ``packed="on"`` raises ``ValueError`` as the JAX
        package does, and ``"auto"`` raises ``NotImplementedError``: the
        JAX package would take its in-jit engine, not ported yet."""
        capped = (self._packed_prep_mode() == "host"
                  and cells > HOST_PREP_MAX_CELLS)
        if binary and supports_packed_relmf(self.num_components) \
                and not capped:
            return True
        if self.packed == "on":
            raise ValueError(
                "packed='on' requires a binarized matrix, num_components "
                "<= 126, and (with CYMF_TPU_RELMF_PREP=host) at most "
                f"{HOST_PREP_MAX_CELLS} cells an epoch (got {cells}; device "
                "prep has no cap)")
        raise NotImplementedError(
            "a non-binary matrix, num_components > 126 or a host-prep epoch "
            f"above {HOST_PREP_MAX_CELLS} cells (device prep has no cap) "
            f"needs the in-jit engine, which {_LATER}")

    @torch.no_grad()
    def fit(self, X, num_epochs: int = 10, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = False, seed: int = 1234, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train; signature parity with `relmf.pyx:67`.

        ``num_threads`` is accepted and ignored; ``seed`` drives the cell
        draws.  After the fit, ``epoch_times_`` holds per epoch the
        device seconds (``device_s``: the epoch's uploads and steps,
        synchronised) and, under host prep or ``engine="pallas"``, the
        host prep seconds (``prep_s``)."""
        if checkpoint_path is not None or resume:
            raise NotImplementedError(f"checkpoints {_LATER}")
        X = as_csr(X)
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
            self._samples_per_epoch = U * I
            self._fit_pallas(X, props, num_epochs, verbose, seed)
            return

        binary = bool(X.nnz == 0 or np.all(X.data == 1.0))
        B = -(-self.batch_size // 1024) * 1024
        S = max(1, -(-(U * I) // B))      # N = U*I samples per epoch
        self.packed_engine_ = self._packed_engine(binary, S * B)
        self._samples_per_epoch = S * B
        self._fit_packed_relmf(X, props, B, S, num_epochs, verbose, seed)

    def _fit_packed_relmf(self, X, props, B, S, num_epochs, verbose, seed):
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
            else "numpy"
        self.last_loss = None
        coo = X.tocoo()
        invp = np.zeros((rh, 1), np.float32)
        invp[:I, 0] = 1.0 / np.maximum(props, self.clip_value)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Wp = put(pk.pack_array(self.W, K, multiple=wrows_w))
        Hp = put(pk.pack_logical(self.H, K, multiple=wrows_h))
        if prep_mode == "device":
            # device prep reads 1/max(p_i, M) from lane K of Hp (the item
            # gather brings it along); gradients are payload-masked, so
            # every optimizer pass leaves it as it is
            Hp[:, K] = put(invp[:, 0])
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        ow, oh = opt.init(Wp), opt.init(Hp)
        # a float: ML-20M's 3.7e9 cells an epoch overflow int32
        n_valid = float(S) * B
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows_w=wrows_w, wrows_h=wrows_h)
        if prep_mode == "device":
            hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
        else:
            pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
            invp_d = put(invp)

        def publish():
            self._state = {"W": unpack_device(Wp, K), "H": Hp[:, :K],
                           "owp": ow, "ohp": oh}

        publish()
        self.epoch_times_ = []
        loss = None

        def epoch_fn(epoch):
            nonlocal loss
            t0 = time.perf_counter()
            times = {}
            if prep_mode == "device":
                loss = packed_relmf_epoch_device(
                    Wp, Hp, ow, oh, hs, epoch_generator(seed, epoch, dev), S,
                    n_valid, B=B, num_users=U, num_items=I, **kw)
            else:
                u2, i2, lab, winw, si, rowsi, wini = prep_relmf_epoch(
                    seed, epoch, S, B, U, I, K, rw, rh, wrows_w, wrows_h,
                    pos_keys)
                t1 = time.perf_counter()
                times["prep_s"], t0 = t1 - t0, t1
                loss = packed_relmf_epoch(
                    Wp, Hp, ow, oh, *(put(a) for a in (
                        u2, i2, lab, si, rowsi, wini, winw)), invp_d,
                    n_valid, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times["device_s"] = time.perf_counter() - t0
            self.epoch_times_.append(times)
            publish()

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose)
        if loss is not None:
            self.last_loss = float(loss)
        self._drop_device_state()

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
        coo = X.tocoo()
        keys = coo.row.astype(np.int64) * I + coo.col
        order = np.argsort(keys)
        pos_keys, pos_vals = keys[order], coo.data[order].astype(np.float32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(
                a.reshape(S, 1, chunk))).to(dev)

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
