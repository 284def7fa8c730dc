"""Bayesian Personalized Ranking (Rendle et al. 2009) — PyTorch trainer.

Behavioural spec from `cymf/bpr.pyx` + `model.pyx:37-87`:
per observed (user, positive) interaction, draw one uniform negative, skip it
if it is a known positive, and descend the pairwise loss

    L = -log(sigmoid(w_u . (h_i - h_j))) + wd * (|w_u|^2 + |h_i|^2 + |h_j|^2)

with gradients exactly as in `model.pyx:80-87` (weight decay folded into the
gradient, no factor 2).

Port of `cymf_tpu/models/bpr.py` on its single-chip packed path
(``_fit_packed``, kernel pipeline v4, numpy host prep): synchronous
minibatches over packed tables, the fused sample kernel and the sorted
accumulations (`ops/packed_epoch.py`).  Initialization, the shuffle, the
batch sort and the negative streams replay the JAX package's numpy
streams, so both packages train on identical inputs.

Not ported yet (see ROADMAP.md, queue 1): the XLA batch engine
(``packed="off"``), the sequential Pallas engine (``engine="pallas"``),
shared negative pools (``neg_pool``), the wide engine (``K >= 128``),
checkpoints, the native C++ prep, device-side prep and the multi-device
engines.  Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import packed as pk
from ..ops.packed_epoch import (make_packed_optimizer, packed_bpr_epoch,
                                prep_epoch, prep_static, unpack_device)
from .base import MFTrainerBase, PersistenceMixin, as_csr

PAD_USER = np.int32(2**31 - 1)  # padding sentinel: sorts last, dropped

_LATER = "is not ported to cymf_tpu_torch yet (ROADMAP.md, queue 1)"


def sorted_batches(X, batch_size: int):
    """The trainer's minibatches of ``X``'s interactions: ``(u2, i2)``,
    int32 ``[S, B]``.  The interactions are shuffled once with numpy's
    global RandomState (as ``sklearn.utils.shuffle`` does in the JAX
    package), padded with ``PAD_USER`` to ``S x B`` with ``B`` rounded up
    to 1024, and each step is sorted by user (order within a synchronous
    batch is semantically irrelevant; the W-side accumulation needs it)."""
    users, positives = X.nonzero()
    order = np.arange(len(users))
    np.random.shuffle(order)
    users = users[order].astype(np.int32)
    positives = positives[order].astype(np.int32)
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
    ``device`` (default :func:`cymf_tpu_torch.config.default_device`)."""

    def __init__(self, num_components: int = 20, learning_rate: float = 0.001,
                 optimizer: str = "adam", weight_decay: float = 0.01,
                 batch_size: int = 1024, update_mode: str = "auto",
                 engine: str = "xla", packed: str = "auto",
                 neg_pool: int = 0, device=None):
        """Arguments as ``cymf_tpu.BPR``.  ``packed="auto"`` and ``"on"``
        both run the packed engine, the only one ported so far;
        ``update_mode`` is validated and, as in the JAX package's packed
        engine, has no effect."""
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
        if engine == "pallas":
            raise NotImplementedError(f"engine='pallas' {_LATER}")
        if packed == "off":
            raise NotImplementedError(f"packed='off' {_LATER}")
        if self.neg_pool:
            raise NotImplementedError(f"neg_pool {_LATER}")
        if not pk.packable(self.num_components):
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
        ``epoch_times_`` holds per epoch the host-prep seconds and the
        device seconds (the epoch's uploads and steps, synchronised).
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

        u2, i2 = sorted_batches(X, self.batch_size)
        self._samples_per_epoch = int(X.count_nonzero())
        self._fit_packed(X, u2, i2, num_epochs, verbose, seed)

    def _fit_packed(self, X, u2, i2, num_epochs, verbose, seed):
        """Packed tables + fused sample kernel + sorted accumulations
        (pipeline v4) with host-side negative streams."""
        self.prep_backend_ = "numpy"
        self.packed_kernel_ = 4
        dev = self.device
        U, I = X.shape
        K = self.num_components
        N = self._samples_per_epoch
        self.last_loss = None
        wrows_w, wrows_h = 256, 256
        rw = pk.packed_rows(U, K, multiple=wrows_w)
        rh = pk.logical_rows(I, multiple=wrows_h)

        winw, si, rowsi, wini = prep_static(u2, i2, K, rw, rh, wrows_w,
                                            wrows_h)
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
            j2, mask, sj, rowsj, winj = prep_epoch(
                rng, u2, i2, pos_keys, U, I, K, rh, wrows_h)
            t1 = time.perf_counter()
            loss = packed_bpr_epoch(
                Wp, Hp, ow, oh, *static,
                *(put(a) for a in (j2, mask, sj, rowsj, winj)), winw_d, N,
                opt_name=self.optimizer, lr=self.learning_rate,
                weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                wrows_w=wrows_w, wrows_h=wrows_h)
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
