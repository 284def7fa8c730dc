"""Bayesian Personalized Ranking (Rendle et al. 2009) — PyTorch trainer.

Behavioural spec from `cymf/bpr.pyx` + `model.pyx:37-87`:
per observed (user, positive) interaction, draw one uniform negative, skip it
if it is a known positive, and descend the pairwise loss

    L = -log(sigmoid(w_u . (h_i - h_j))) + wd * (|w_u|^2 + |h_i|^2 + |h_j|^2)

with gradients exactly as in `model.pyx:80-87` (weight decay folded into the
gradient, no factor 2).

Port of `cymf_tpu/models/bpr.py` on two engines:

- ``engine="xla"``: its single-chip packed path (``_fit_packed``, numpy
  host prep): synchronous minibatches over packed tables, the fused sample
  kernels and the sorted accumulations (`ops/packed_epoch.py`).  The
  kernel pipeline is the JAX package's data-dependent choice
  (``packed_epoch.engine_version``, recorded in ``packed_kernel_``): v5 or
  v6 where every chunk of a step's user-sorted stream spans few enough
  packed rows (small or dense catalogs; v6 needs 512-row blocks, so
  ``fit`` at its 256-row windows takes v5), v4 on sparse streams such as
  ML-20M's, v7 only when ``CYMF_TPU_PACKED_KERNEL=7`` forces it.
  ``neg_pool=P`` takes the shared-negative-pool pipeline v8;
- ``engine="pallas"``: the sequential small-catalog engine
  (``_fit_pallas``, `ops/pallas_engine.py`): per-sample updates in groups
  of 8, one kernel launch an epoch, or one for the whole fit when no
  validator watches the epochs.

Initialization, the shuffle, the batch sort and the negative streams
replay the JAX package's numpy streams, so both packages train on
identical inputs.

Not ported yet (see ROADMAP.md, queue 1): the XLA batch engine
(``packed="off"``), the wide engine (``K >= 128``), checkpoints, the
native C++ prep, device-side prep and the multi-device engines.  Each
raises ``NotImplementedError`` under ``engine="xla"``;
``engine="pallas"`` takes none of them, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import packed as pk
from ..ops import pallas_engine as pe
from ..ops.fused_step import supports_v8
from ..ops.packed_epoch import (make_packed_optimizer, packed_bpr_epoch,
                                packed_bpr_pool_epoch, prep_epoch,
                                prep_pool_epoch, prep_static,
                                prep_static_pool, unpack_device)
from .base import MFTrainerBase, PersistenceMixin, as_csr

PAD_USER = np.int32(2**31 - 1)  # padding sentinel: sorts last, dropped

_LATER = "is not ported to cymf_tpu_torch yet (ROADMAP.md, queue 1)"


def shuffled_interactions(X):
    """``X``'s interactions ``(users, positives)``, int32, shuffled once
    with numpy's global RandomState (the draw of ``sklearn.utils.shuffle``
    in the JAX package)."""
    users, positives = X.nonzero()
    order = np.arange(len(users))
    np.random.shuffle(order)
    return users[order].astype(np.int32), positives[order].astype(np.int32)


def sorted_batches(users, positives, batch_size: int):
    """The packed engine's minibatches of the shuffled interactions
    (:func:`shuffled_interactions`): ``(u2, i2)``, int32 ``[S, B]``,
    padded with ``PAD_USER`` to ``S x B`` with ``B`` rounded up to 1024,
    each step sorted by user (order within a synchronous batch is
    semantically irrelevant; the W-side accumulation needs it)."""
    N = len(users)
    B = min(int(batch_size), max(N, 1))
    B = -(-B // 1024) * 1024
    S = max(1, -(-N // B))
    pad = S * B - N
    if pad:
        users = np.concatenate([users, np.full(pad, PAD_USER, np.int32)])
        positives = np.concatenate([positives, np.zeros(pad, np.int32)])
    u2 = users.reshape(S, B)
    i2 = positives.reshape(S, B)
    order = np.argsort(u2, axis=1, kind="stable")
    return (np.take_along_axis(u2, order, axis=1),
            np.take_along_axis(i2, order, axis=1))


class BPR(MFTrainerBase, PersistenceMixin):
    """API-compatible rebuild of ``cymf.BPR`` (`bpr.pyx:37-68`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU."""

    def __init__(self, num_components: int = 20, learning_rate: float = 0.001,
                 optimizer: str = "adam", weight_decay: float = 0.01,
                 batch_size: int = 1024, update_mode: str = "auto",
                 engine: str = "xla", packed: str = "auto",
                 neg_pool: int = 0, device=None):
        """Arguments as ``cymf_tpu.BPR``.  Under ``engine="xla"``,
        ``packed="auto"`` and ``"on"`` both run the packed engine, the only
        XLA engine ported so far; ``update_mode`` is validated and, as in
        the JAX package's packed and sequential engines, has no effect.
        ``neg_pool=P`` (a multiple of 128 in [128, 2048]) draws each
        step's negatives from a pool of P items (pipeline v8)."""
        super().__init__(num_components, device=device)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.weight_decay = float(weight_decay)
        self.batch_size = int(batch_size)
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError("update_mode must be auto|dense|sparse")
        self.update_mode = update_mode
        if engine not in ("xla", "pallas"):
            raise ValueError("engine must be 'xla' or 'pallas'")
        self.engine = engine
        if packed not in ("auto", "on", "off"):
            raise ValueError("packed must be auto|on|off")
        self.packed = packed
        if packed == "on" and engine != "xla":
            raise ValueError("packed='on' requires engine='xla'")
        self.neg_pool = int(neg_pool)
        if self.neg_pool and (self.neg_pool < 128 or self.neg_pool % 128
                              or self.neg_pool > 2048):
            raise ValueError("neg_pool must be 0 or a multiple of 128 in "
                             "[128, 2048]")
        if self.neg_pool and packed == "off":
            raise ValueError("neg_pool requires the packed engine")
        if self.optimizer not in ("sgd", "adagrad", "adam"):
            raise Exception(f"{self.optimizer} is invalid.")
        # the sequential engine takes none of these, as in the JAX package
        if engine == "xla" and packed == "off":
            raise NotImplementedError(f"packed='off' {_LATER}")
        if engine == "xla" and not pk.packable(self.num_components):
            raise NotImplementedError(
                f"num_components >= 128 (the wide engine) {_LATER}")

    @torch.no_grad()
    def fit(self, X, num_epochs: int = 10, num_threads: int = 1,
            valid_evaluator=None, early_stopping: bool = False,
            verbose: bool = True, seed: int = 1234,
            checkpoint_path=None, checkpoint_every: int = 1,
            resume: bool = False):
        """Train; signature parity with `bpr.pyx:68`.

        ``num_threads`` is accepted and ignored.  ``seed`` drives the
        negative sampler (`bpr.pyx:148`).  After the fit,
        ``epoch_times_`` holds per epoch the device seconds (``device_s``:
        the epoch's uploads and steps, synchronised) and, on the packed
        engine, the host-prep seconds (``prep_s``).  The sequential engine
        logs one entry per launch, with the epochs it ran (``epochs``):
        one entry for a fit that runs as one launch.
        """
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

        users, positives = shuffled_interactions(X)
        self._samples_per_epoch = len(users)
        if self.engine == "pallas":
            self._fit_pallas(X, users, positives, num_epochs, verbose, seed)
            return
        u2, i2 = sorted_batches(users, positives, self.batch_size)
        self._fit_packed(X, u2, i2, num_epochs, verbose, seed)

    def _fit_packed(self, X, u2, i2, num_epochs, verbose, seed):
        """Packed tables + fused kernels + sorted accumulations with
        host-side negative streams; the pipeline as ``prep_static`` (or,
        with ``neg_pool``, v8) picks it."""
        self.prep_backend_ = "numpy"
        dev = self.device
        U, I = X.shape
        K = self.num_components
        N = self._samples_per_epoch
        self.last_loss = None
        wrows_w, wrows_h = 256, 256
        rw = pk.packed_rows(U, K, multiple=wrows_w)
        rh = pk.logical_rows(I, multiple=wrows_h)

        if self.neg_pool:
            if not supports_v8(K, rw, wrows_w, self.neg_pool):
                raise ValueError(
                    f"neg_pool={self.neg_pool} unsupported at "
                    f"num_components={K}: needs s*(K+1) <= 127 and a "
                    "lane-aligned pool")
            winw, si, rowsi, wini = prep_static_pool(
                u2, i2, K, rw, rh, wrows_w, wrows_h)
            wstart = bcs = bcn = np.zeros((u2.shape[0], 1), np.int32)
            kernel_v = 8
        else:
            winw, wstart, si, rowsi, wini, bcs, bcn, kernel_v = \
                prep_static(u2, i2, K, rw, rh, wrows_w, wrows_h)
        # which pipeline runs (8/6/5/4, data-dependent; 7 when forced)
        self.packed_kernel_ = kernel_v
        coo = X.tocoo()
        pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Wp = put(pk.pack_array(self.W, K, multiple=wrows_w))
        Hp = put(pk.pack_logical(self.H, K, multiple=wrows_h))
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        ow, oh = opt.init(Wp), opt.init(Hp)
        static = [put(a) for a in (u2, i2, si, rowsi, wini)]
        winw_d = put(winw)
        blocks = [put(a) for a in (wstart, bcs, bcn)]
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows_w=wrows_w, wrows_h=wrows_h)
        rjs_d = None
        if kernel_v == 8:
            # the per-sample pool slots are drawn once per fit (a fresh
            # uniform pool each epoch makes j = pool[r] as uniform as
            # redrawing r); each epoch draws its pool from (seed, epoch)
            r2_fit = np.random.default_rng((seed, 1 << 20)).integers(
                0, self.neg_pool, u2.shape, dtype=np.int32)
            rjs_d = put(r2_fit.reshape(u2.shape[0], u2.shape[1] // 128, 128))

        def publish():
            self._state = {"W": unpack_device(Wp, K), "H": Hp[:, :K],
                           "owp": ow, "ohp": oh}

        publish()
        self.epoch_times_ = []
        loss = None

        def epoch_fn(epoch):
            nonlocal loss
            t0 = time.perf_counter()
            rng = np.random.default_rng((seed, epoch))
            if kernel_v == 8:
                pool2, _, mask, _ = prep_pool_epoch(
                    rng, u2, pos_keys, U, I, self.neg_pool, r2=r2_fit)
                t1 = time.perf_counter()
                loss = packed_bpr_pool_epoch(
                    Wp, Hp, ow, oh, *static, put(pool2), rjs_d, put(mask),
                    winw_d, N, **kw)
            else:
                j2, mask, sj, rowsj, winj = prep_epoch(
                    rng, u2, i2, pos_keys, U, I, K, rh, wrows_h)
                t1 = time.perf_counter()
                loss = packed_bpr_epoch(
                    Wp, Hp, ow, oh, *static,
                    *(put(a) for a in (j2, mask, sj, rowsj, winj)), winw_d,
                    *blocks, N, kernel_v=kernel_v, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(
                {"prep_s": t1 - t0, "device_s": time.perf_counter() - t1})
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

    def _fit_pallas(self, X, users, positives, num_epochs, verbose, seed,
                    chunk: int = 4096, group: int = 8):
        """Sequential per-sample training (`ops/pallas_engine.py`), as
        ``cymf_tpu.BPR._fit_pallas``: chunks of 4096 samples in groups of
        8, every epoch's negatives drawn in one host pass."""
        U, I = X.shape
        if not pe.fits_vmem(U + I, self.optimizer):
            raise ValueError(
                "tables + optimizer state exceed the sequential engine's "
                "budget (the JAX package's VMEM gate); use engine='xla' for "
                "catalogs of this size")
        dev = self.device
        K = self.num_components
        N = len(users)
        chunk = min(chunk, max(N, group))
        chunk = max(group, (chunk // group) * group)
        S = max(1, -(-N // chunk))
        pad = S * chunk - N
        u_pad = np.concatenate([users, np.zeros(pad, np.int32)])
        i_pad = np.concatenate([positives, np.zeros(pad, np.int32)])
        in_data = np.concatenate([np.ones(N, np.int32),
                                  np.zeros(pad, np.int32)])
        coo = X.tocoo()
        pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
        # every epoch's negatives and rejection masks in one host pass
        # (fresh draws per epoch, as the reference samples at bpr.pyx:165)
        j_all, keep_all = pe.generate_epoch_negatives(
            np.random.default_rng(seed), np.tile(u_pad, num_epochs), I,
            pos_keys)
        mask_all = np.tile(in_data, num_epochs) & keep_all.astype(np.int32)

        def put(a, epochs=1):
            return torch.from_numpy(np.ascontiguousarray(
                a.reshape(epochs * S, 1, chunk))).to(dev)

        Wp = pe.pack_table(self.W, self.optimizer, dev)
        Hp = pe.pack_table(self.H, self.optimizer, dev)
        self._state = {"W": pe.unpack_table(Wp, K),
                       "H": pe.unpack_table(Hp, K)}
        self.last_loss = None
        self.epoch_times_ = []
        kw = dict(optimizer=self.optimizer, lr=self.learning_rate,
                  wd=self.weight_decay, group=group)

        def launch(u, i, j, mask, epochs):
            t0 = time.perf_counter()
            loss = pe.bpr_pallas_epoch(Wp, Hp, u, i, j, mask, **kw)[2]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(
                {"device_s": time.perf_counter() - t0, "epochs": epochs})
            return loss

        if self.valid_evaluator is None and num_epochs > 1:
            # no per-epoch validation: the whole fit is one launch
            loss = launch(put(np.tile(u_pad, num_epochs), num_epochs),
                          put(np.tile(i_pad, num_epochs), num_epochs),
                          put(j_all, num_epochs), put(mask_all, num_epochs),
                          num_epochs)
            self.last_loss = float(loss) / max(N * num_epochs, 1)
            self._drop_device_state()
            return

        u_d, i_d = put(u_pad), put(i_pad)
        j_all = j_all.reshape(num_epochs, S * chunk)
        mask_all = mask_all.reshape(num_epochs, S * chunk)
        loss = None

        def epoch_fn(epoch):
            nonlocal loss
            loss = launch(u_d, i_d, put(j_all[epoch]), put(mask_all[epoch]),
                          1)

        def snapshot_fn():
            return (self.W, self.H)

        def restore_fn(snap):
            self.W, self.H = snap

        self._run_epochs(num_epochs, epoch_fn, snapshot_fn, restore_fn,
                         verbose)
        if loss is not None:
            self.last_loss = float(loss / max(N, 1))     # float32, as JAX
        self._drop_device_state()
