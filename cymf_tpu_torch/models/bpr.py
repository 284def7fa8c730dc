"""Bayesian Personalized Ranking (Rendle et al. 2009) — PyTorch trainer.

Behavioural spec from `cymf/bpr.pyx` + `model.pyx:37-87`:
per observed (user, positive) interaction, draw one uniform negative, skip it
if it is a known positive, and descend the pairwise loss

    L = -log(sigmoid(w_u . (h_i - h_j))) + wd * (|w_u|^2 + |h_i|^2 + |h_j|^2)

with gradients exactly as in `model.pyx:80-87` (weight decay folded into the
gradient, no factor 2).

Port of `cymf_tpu/models/bpr.py` on two engines:

- ``engine="xla"``: its single-device paths, synchronous minibatches.
  The fused ones (host prep, native by default, numpy under
  ``CYMF_TPU_PREP=numpy``; see ``packed_epoch.prep_backend``) run the
  sorted accumulations.  For K <= 127 the packed path (``_fit_packed``,
  `ops/packed_epoch.py`): packed tables and
  the fused sample kernels.  The kernel pipeline is the JAX package's
  data-dependent choice (``packed_epoch.engine_version``, recorded in
  ``packed_kernel_``): v5 or v6 where every chunk of a step's user-sorted
  stream spans few enough packed rows (small or dense catalogs; v6 needs
  512-row blocks, so ``fit`` at its 256-row windows takes v5), v4 on
  sparse streams such as ML-20M's, v7 only when
  ``CYMF_TPU_PACKED_KERNEL=7`` forces it.  ``neg_pool=P`` takes the
  shared-negative-pool pipeline v8.  For K >= 128 the wide path
  (``_fit_wide``, `ops/wide_epoch.py`): ``(rows, Kp)`` tables, the
  sample math in torch and the count-lane accumulations.  The portable
  batch engine (``_fit_batch``, :func:`_bpr_epoch`, ``packed="off"``):
  logical tables, negatives drawn on the tables' device and rejected by
  the pair hash set inside the step, and the row updates of
  :mod:`cymf_tpu_torch.optim`, dense or sparse (:func:`choose_update_mode`);
- ``engine="pallas"``: the sequential small-catalog engine
  (``_fit_pallas``, `ops/pallas_engine.py`): per-sample updates in groups
  of 8, one kernel launch an epoch, or one for the whole fit when no
  validator watches the epochs.

``packed="auto"`` follows the JAX rule with the card in the TPU's place
(:meth:`BPR._fused_engine`): on a CUDA device a fused engine takes a fit
of at least 4096 interactions, a smaller fit the batch engine.  The one
deliberate difference: on the CPU ``"auto"`` takes the fused engine at
any size (its plain forms are what the CPU tests hold against the card's
kernels), where the JAX package would take the batch engine.

Initialization, the shuffle and the batch sort replay the JAX package's
numpy streams, and the fused engines' negative streams too, so both
packages train on identical inputs.  The batch engine draws its negatives
from a ``torch.Generator`` a fit and epoch (:func:`_draw_negatives`), a
stream the JAX package's threefry draws differ from.

``fit(checkpoint_path=p)`` writes each engine's state in the JAX
package's schema (``{"W", "H", "ow", "oh"}`` batch, ``{"W", "H", "owp",
"ohp"}`` packed, ``{"W", "H", "oww", "ohw"}`` wide) and ``resume=True``
continues from it: any engine from any engine's checkpoint, of either
package, at any row padding (:func:`_packed_resume_state`,
:func:`_batch_resume_state`, :func:`_wide_resume_state`).  The sequential
engine refuses checkpoints, as in the JAX package.

``CYMF_TPU_BPR_PREP=device`` (read by the packed engine alone, as in the
JAX package) prepares the negative side on the card
(:func:`~cymf_tpu_torch.ops.packed_epoch.packed_bpr_epoch_device`):
pipeline v4, draws from a ``torch.Generator`` a fit and epoch, a stream
the JAX package's threefry draws differ from (``prep_backend_ ==
"device-torch"``).

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``: one
process per device, every rank running the same ``fit``), the fit routes
as the JAX package's does on a multi-device mesh: the packed engine to
``_fit_packed_sharded`` (row-sharded packed W, replicated H, one
all-reduce of the item-side sums a step,
``parallel/shard_step.py::sharded_packed_bpr_epoch``; pipeline v4, or with
``neg_pool`` a warning and the single-device pool engine on every rank),
the wide engine to ``_fit_wide_sharded`` and the batch engine to
``_fit_batch_sharded`` (both tables row-sharded, the O(batch) row
exchange, dense updates).  Every rank draws the whole epoch's negatives
(the 1-device stream) and takes its shard's slice, so the fit equals the
1-device fit up to float summation order.  ``model.W`` is then a
collective during the fit (``models/base.py``).
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
from ..ops.fused_step import supports_v8
from ..ops.hashset import build_pair_hashset, to_device
from ..ops.packed_epoch import (live_negatives, log_sigmoid,
                                make_packed_optimizer, make_reject_filter,
                                packed_bpr_epoch, packed_bpr_epoch_device,
                                packed_bpr_pool_epoch, prep_backend,
                                prep_epoch, prep_pool_epoch,
                                prep_shard_epoch, prep_shard_static,
                                prep_static, prep_static_pool, row_dot,
                                sigmoid, unpack_device)
from ..ops.relmf_epoch import epoch_generator
from ..ops.wide_epoch import (pack_wide, prep_shard_static_wide,
                              prep_static_wide, wide_bpr_epoch, wide_rows,
                              wide_shard_masks, wide_sorted_masks)
from ..optim import make_optimizer
from ..parallel.shard_step import (sharded_bpr_epoch,
                                   sharded_packed_bpr_epoch,
                                   sharded_wide_bpr_epoch)
from ..parallel.mesh import host_array
from ..utils.checkpoint import check_leaves
from .base import MFTrainerBase, PersistenceMixin, as_csr

PAD_USER = np.int32(2**31 - 1)  # padding sentinel: sorts last, dropped


def _load_ckpt_raw(path):
    """Engine-agnostic checkpoint read: raw flat leaf dict + epoch.

    BPR's engines store state under different schemas (logical tables +
    ``ow``/``oh`` optimizer leaves for the batch engine, packed-layout
    ``owp``/``ohp`` for the packed one, lane-padded ``oww``/``ohw`` for
    the wide one) and each may resume a checkpoint another wrote, so
    resume starts from the raw dict and converts
    (`utils/checkpoint.py` loads the same-schema case elsewhere)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    epoch = int(flat.pop("__epoch__", -1))
    for k in list(flat):
        if k.startswith("__meta__/"):
            flat.pop(k)
    check_leaves(flat)
    return flat, epoch


def _resume_point(checkpoint_path, resume: bool):
    """``(flat, start_epoch)``: the raw leaves of the checkpoint a fit
    resumes from (:func:`_load_ckpt_raw`) and the epoch after the saved
    one, or ``(None, 0)`` when the fit starts afresh (``resume`` off, or
    no file at ``checkpoint_path`` yet)."""
    if resume and checkpoint_path is not None \
            and os.path.exists(checkpoint_path):
        flat, last_epoch = _load_ckpt_raw(checkpoint_path)
        return flat, last_epoch + 1
    return None, 0


def _put(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device, dtype)


def _restore_opt_state(flat, native_prefix, other_prefix, template,
                       convert, paymask, repad=None):
    """Rebuild one table's optimizer-state dict from checkpoint leaves,
    as tensors on the template's device and of its dtype.

    Leaves under ``native_prefix`` (this engine's own layout) load
    verbatim when shapes match; on a row-padding mismatch (a checkpoint
    written under another device count) they run through ``repad``
    (same-layout slice + re-pad, the conversion the tables themselves
    get) and splice into ``template`` where ``paymask`` is True.  Leaves
    under ``other_prefix`` run through ``convert`` (the cross-engine
    layout transform) with the same splice: positions outside the
    payload keep their initializer values (e.g. AdaGrad's ones on packed
    count/dead lanes).
    """
    out = {}
    for sub, tleaf in template.items():
        t = host_array(tleaf)
        nk, ok = f"{native_prefix}/{sub}", f"{other_prefix}/{sub}"
        if nk in flat:
            arr = np.asarray(flat[nk])
            if arr.shape != t.shape:
                # repad only heals ROW-count mismatches (same layout,
                # different device padding); any trailing-dim difference
                # is a genuinely different layout/version
                if repad is None or arr.ndim != t.ndim \
                        or arr.shape[1:] != t.shape[1:]:
                    raise ValueError(
                        f"checkpoint leaf {nk!r} has shape {arr.shape}, "
                        f"expected {t.shape} — written by an "
                        "incompatible layout/version")
                arr = np.where(paymask, repad(arr), t)
        elif ok in flat:
            arr = np.where(paymask, convert(np.asarray(flat[ok])), t)
        else:
            raise KeyError(
                f"checkpoint has neither {nk!r} nor {ok!r} — not a BPR "
                "checkpoint for this optimizer")
        out[sub] = _put(arr, tleaf.device, tleaf.dtype)
    return out


def _packed_resume_state(flat, U, I, K, mult_w, wrows_h, ow, oh, device):
    """Rebuild the packed engine's state from a raw checkpoint dict (any
    engine's schema, see :func:`_load_ckpt_raw`) under W row padding
    ``mult_w`` and H row padding ``wrows_h``, on ``device``.  Returns
    ``(Wp, Hp, ow, oh)``."""
    # tables: every engine schema stores logical rows
    Wp = _put(pk.pack_array(np.asarray(flat["W"])[:U], K, multiple=mult_w),
              device)
    Hp = _put(pk.pack_logical(np.asarray(flat["H"])[:I], K,
                              multiple=wrows_h), device)

    def pack_w(a):  # logical (>=U, K) -> packed (rw, 128)
        return pk.pack_array(a[:U], K, multiple=mult_w)

    def pack_h(a):  # logical (>=I, K) -> logical-layout (rh, 128)
        return pk.pack_logical(a[:I], K, multiple=wrows_h)

    mpay_w = pk.pack_array(np.ones((U, K), np.float32), K,
                           multiple=mult_w) > 0
    mpay_h = pk.pack_logical(np.ones((I, K), np.float32), K,
                             multiple=wrows_h) > 0
    s_k = pk.num_slots(K)

    def repad_wp(a):  # packed layout under a different row pad
        return pk.pack_array(a[:, :s_k * K].reshape(-1, K)[:U], K,
                             multiple=mult_w)

    def repad_hp(a):  # logical layout under a different row pad
        return pk.pack_logical(a[:I, :K], K, multiple=wrows_h)

    ow = _restore_opt_state(flat, "owp", "ow", ow, pack_w, mpay_w,
                            repad=repad_wp)
    oh = _restore_opt_state(flat, "ohp", "oh", oh, pack_h, mpay_h,
                            repad=repad_hp)
    return Wp, Hp, ow, oh


def _wide_to_logical(flat, U, I, K):
    """Add the batch engine's logical ``ow/*``/``oh/*`` leaves for a wide
    engine's checkpoint (``oww``/``ohw``: logical rows, lane-padded
    columns), so the logical-to-layout converters read it too."""
    for pre, n_rows in (("oww", U), ("ohw", I)):
        for k in [k for k in flat if k.startswith(pre + "/")]:
            dst = ("ow/" if pre == "oww" else "oh/") + k.split("/", 1)[1]
            if dst not in flat:
                flat[dst] = np.asarray(flat[k])[:n_rows, :K]


def _batch_resume_state(flat, U, I, K, ow, oh, device):
    """Rebuild the batch engine's logical state ``(W, H, ow, oh)`` on
    ``device`` from a raw checkpoint dict of any engine (batch, packed,
    wide), at any row padding; the tables in the param dtype, each state
    in its template's dtype."""
    W = _put(np.asarray(flat["W"])[:U], device, config.param_dtype())
    H = _put(np.asarray(flat["H"])[:I], device, config.param_dtype())
    s = pk.num_slots(K)

    def unpack_w(a):  # packed (rw, 128) -> logical (U, K)
        return a[:, :s * K].reshape(-1, K)[:U]

    def unpack_h(a):  # logical-layout (rh, 128) -> (I, K)
        return a[:I, :K]

    _wide_to_logical(flat, U, I, K)
    ow = _restore_opt_state(flat, "ow", "owp", ow, unpack_w, True,
                            repad=lambda a: a[:U])
    oh = _restore_opt_state(flat, "oh", "ohp", oh, unpack_h, True,
                            repad=lambda a: a[:I])
    return W, H, ow, oh


def _sharded_batch_state(model, mesh, opt, U: int, I: int, checkpoint_path,
                         resume: bool):
    """A batch engine's state on a mesh (BPR's and RelMF's): this rank's
    row shards of W, H and their optimizer states, rows padded by
    ``mesh.pad_rows`` (the states' pad rows keep their init), from the
    model's tables or from the checkpoint any engine wrote at any row
    padding; and the start epoch, which the ranks must agree on."""
    K = model.num_components
    W_, H_ = model.W, model.H
    owf = opt.init(torch.zeros((mesh.pad_rows(U), K)))
    ohf = opt.init(torch.zeros((mesh.pad_rows(I), K)))
    flat, start_epoch = _resume_point(checkpoint_path, resume)
    mesh.agree(start_epoch, "the checkpoint's epoch")
    if flat is not None:
        W_, H_, ow_, oh_ = _batch_resume_state(
            flat, U, I, K, opt.init(torch.zeros((U, K))),
            opt.init(torch.zeros((I, K))), "cpu")
        for k in owf:
            owf[k][:U] = ow_[k]
        for k in ohf:
            ohf[k][:I] = oh_[k]
    return (model._pad_table(W_), model._pad_table(H_),
            {k: mesh.put_table(v) for k, v in owf.items()},
            {k: mesh.put_table(v) for k, v in ohf.items()}, start_epoch)


def _wide_resume_state(flat, U, I, K, mult_w, wrows, ow, oh, device):
    """Rebuild the wide engine's state ``(Wd, Hd, ow, oh)`` (``(rows,
    Kp)`` tables: W rows padded to ``mult_w``, H rows to ``wrows``) on
    ``device`` from a raw checkpoint dict of the wide or the batch
    engine."""
    Wd = _put(pack_wide(np.asarray(flat["W"])[:U], K, multiple=mult_w),
              device)
    Hd = _put(pack_wide(np.asarray(flat["H"])[:I], K, multiple=wrows),
              device)

    def cvt_w(a):  # logical leaf (>=U, K) -> wide layout
        return pack_wide(a[:U], K, multiple=mult_w)

    def cvt_h(a):
        return pack_wide(a[:I], K, multiple=wrows)

    mpay_w = pack_wide(np.ones((U, K), np.float32), K, multiple=mult_w) > 0
    mpay_h = pack_wide(np.ones((I, K), np.float32), K, multiple=wrows) > 0
    ow = _restore_opt_state(flat, "oww", "ow", ow, cvt_w, mpay_w,
                            repad=cvt_w)
    oh = _restore_opt_state(flat, "ohw", "oh", oh, cvt_h, mpay_h,
                            repad=cvt_h)
    return Wd, Hd, ow, oh


def _cap_prep_threads(mesh) -> None:
    """Cap the native prep's OpenMP threads at (cores / ranks on this
    host), so that the ranks of one host do not oversubscribe it."""
    if prep_backend() == "native":
        from .. import native
        native.set_num_threads(min(native.num_threads(), max(
            1, (os.cpu_count() or 1) // mesh.local_ranks)))


def shuffled_interactions(X):
    """``X``'s interactions ``(users, positives)``, int32, shuffled once
    with numpy's global RandomState (the draw of ``sklearn.utils.shuffle``
    in the JAX package)."""
    users, positives = X.nonzero()
    order = np.arange(len(users))
    np.random.shuffle(order)
    return users[order].astype(np.int32), positives[order].astype(np.int32)


def sorted_batches(users, positives, batch_size: int, multiple: int = 1024):
    """The minibatches of the shuffled interactions
    (:func:`shuffled_interactions`): ``(u2, i2)``, int32 ``[S, B]``,
    padded with ``PAD_USER`` to ``S x B`` with ``B`` rounded up to a
    ``multiple`` (1024 for the fused engines, 1 for the batch engine),
    each step sorted by user (order within a synchronous batch is
    semantically irrelevant; the W-side accumulation needs it)."""
    N = len(users)
    B = min(int(batch_size), max(N, 1))
    B = -(-B // multiple) * multiple
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


def choose_update_mode(mode: str, batch_rows: int, table_rows: int) -> str:
    """'auto' resolves to dense when the batch covers enough of the table
    that a full-table pass is cheaper than sorted row-scatters."""
    if mode != "auto":
        return mode
    return "dense" if batch_rows * 16 >= table_rows else "sparse"


def _draw_negatives(gen: torch.Generator, B: int, num_items: int,
                    device) -> torch.Tensor:
    """One step's ``B`` uniform negatives over ``[0, num_items)``, int32 on
    ``device``, from ``gen``: the batch engine's only draw."""
    return torch.randint(0, num_items, (B,), generator=gen, device=device,
                         dtype=torch.int32)


def _bpr_epoch(W, H, opt_w, opt_h, u_steps, i_steps, hs, n_valid, gen, *,
               optimizer, weight_decay: float, num_users: int,
               num_items: int, update_mode: str = "dense") -> torch.Tensor:
    """One epoch of the batch engine over ``S`` minibatch steps
    (``u_steps``, ``i_steps``: int32 ``[S, B]`` on the tables' device),
    as ``cymf_tpu.models.bpr._bpr_epoch``.  Each step draws its negatives
    from ``gen`` (:func:`_draw_negatives`), masks padding users
    (``PAD_USER``) and negatives the pair hash set ``hs`` holds, and
    applies one synchronous update per table.  Updates ``W``, ``H`` and
    the optimizer states IN PLACE; returns the mean loss (0-d tensor,
    ``sum / max(n_valid, 1)``).

    ``update_mode``: "dense" scatters the per-sample gradients into a
    table-shaped buffer and makes one masked full-table pass; "sparse"
    sort-dedups and updates the touched rows only.  Both make one step a
    touched row with its summed gradient.
    """
    S, B = u_steps.shape
    dev = W.device
    nw = W.shape[0]
    weight_decay = config.scalar(weight_decay, W.dtype)
    loss_acc = torch.zeros((), dtype=W.dtype, device=dev)
    for t in range(S):
        u, i = u_steps[t], i_steps[t]
        j = _draw_negatives(gen, B, num_items, dev)
        # padding samples carry PAD_USER: the gather clamps, every scatter
        # drops them (optim), and the mask zeroes their gradients
        mf = live_negatives(hs, u, j, num_users).to(W.dtype)[:, None]
        wu = W.index_select(0, u.clamp(max=nw - 1))
        hi, hj = H.index_select(0, i), H.index_select(0, j)
        x = row_dot(wu, hi - hj, keepdim=True)
        sig = sigmoid(-x)  # 1/(1+e^x), cf. model.pyx:78
        # gradients per model.pyx:81-83 (decay inside the gradient)
        g_wu = -(sig * (hi - hj) - weight_decay * wu) * mf
        g_hi = -(sig * wu - weight_decay * hi) * mf
        g_hj = -(-sig * wu - weight_decay * hj) * mf
        l2 = row_dot(wu, wu) + row_dot(hi, hi) + row_dot(hj, hj)
        loss = (-log_sigmoid(x[:, 0])
                + weight_decay * l2) * mf[:, 0]
        if update_mode == "dense":
            optimizer.update_dense(W, opt_w, [(u, g_wu)])
            optimizer.update_dense(H, opt_h, [(i, g_hi), (j, g_hj)])
        else:
            optimizer.update_rows(W, opt_w, u, g_wu)
            optimizer.update_rows(H, opt_h, torch.cat([i, j]),
                                  torch.cat([g_hi, g_hj]))
        loss_acc += torch.sum(loss)
    return loss_acc / config.scalar(float(max(int(n_valid), 1)), W.dtype)


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
        ``packed="on"`` runs the fused engines, packed for K <= 127 and
        wide for K >= 128, ``packed="off"`` the batch engine, and
        ``packed="auto"`` picks as :meth:`_fused_engine` says.
        ``update_mode`` picks the batch engine's update (dense, sparse, or
        by :func:`choose_update_mode`); as in the JAX package's fused and
        sequential engines, it has no effect on them.
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

    def _fused_engine(self, device_type: str, n_samples: int) -> str:
        """The engine of an ``engine="xla"`` fit: ``"packed"`` (K <= 127),
        ``"wide"`` (K >= 128) or ``"batch"``.  ``packed="on"`` forces the
        fused one and ``"off"`` the batch engine; under ``"auto"`` a CUDA
        device takes the fused one at 4096 interactions or more (the JAX
        rule, `cymf_tpu/models/bpr.py:353-358`, with the card in the TPU's
        place), and the CPU takes it at any size."""
        kind = "packed" if pk.packable(self.num_components) else "wide"
        if self.packed == "off":
            return "batch"
        if self.packed == "on" or device_type != "cuda" \
                or n_samples >= 4096:
            return kind
        return "batch"

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
        the epoch's uploads and steps) and, on the packed and wide
        engines, the host-prep seconds (``prep_s``; each epoch's prep runs
        beside the previous epoch's device work).  The
        sequential engine logs one entry per launch, with the epochs it ran
        (``epochs``): one entry for a fit that runs as one launch.
        """
        X = as_csr(X)
        self.valid_evaluator = valid_evaluator
        self.valid_dcg = -np.inf
        self.early_stopping = early_stopping
        if early_stopping and valid_evaluator is None:
            raise ValueError()

        U, I = X.shape
        n = self._mesh_device().num_devices
        self._num_users, self._num_items = U, I
        self._ensure_tables(U, I)

        users, positives = shuffled_interactions(X)
        self._samples_per_epoch = len(users)
        if self.engine == "pallas":
            if checkpoint_path is not None:
                raise NotImplementedError(
                    "checkpointing is only supported with engine='xla'")
            self.engine_ = "pallas"
            self._fit_pallas(X, users, positives, num_epochs, verbose, seed)
            return
        self.engine_ = self._fused_engine(self.device.type, len(users))
        if self.neg_pool and self.engine_ != "packed":
            raise ValueError(
                "neg_pool requires the packed engine (K <= 127 and a "
                "single-device TPU run, or packed='on'); this fit "
                f"selected {self.engine_!r}")
        ckpt = (checkpoint_path, checkpoint_every, resume)
        if self.engine_ == "batch":
            if n > 1:
                # the batch split evenly over the ranks (mesh.pad_rows)
                u2, i2 = sorted_batches(
                    users, positives, min(self.batch_size,
                                          max(len(users), n)), multiple=n)
                self._fit_batch_sharded(X, u2, i2, num_epochs, verbose,
                                        seed, *ckpt)
                return
            u2, i2 = sorted_batches(users, positives, self.batch_size,
                                    multiple=1)
            self._fit_batch(X, u2, i2, num_epochs, verbose, seed, *ckpt)
            return
        u2, i2 = sorted_batches(users, positives, self.batch_size)
        if self.engine_ == "packed":
            if n > 1 and not self.neg_pool:
                self._fit_packed_sharded(X, u2, i2, num_epochs, verbose,
                                         seed, *ckpt)
                return
            if n > 1:
                warnings.warn(
                    "neg_pool is a single-chip structure: the "
                    f"{n}-rank mesh is ignored and every rank runs the pool "
                    "engine on its own device", stacklevel=2)
            self._fit_packed(X, u2, i2, num_epochs, verbose, seed, *ckpt)
            return
        if n > 1:
            self._fit_wide_sharded(X, u2, i2, num_epochs, verbose, seed,
                                   *ckpt)
            return
        self._fit_wide(X, u2, i2, num_epochs, verbose, seed, *ckpt)

    def _fit_batch_sharded(self, X, u2, i2, num_epochs, verbose, seed,
                           checkpoint_path, checkpoint_every, resume):
        """The batch engine on a mesh (:func:`~cymf_tpu_torch.parallel.
        shard_step.sharded_bpr_epoch`), as the mesh branch of
        ``cymf_tpu.BPR.fit``: W and H row-sharded over the ranks (padded by
        ``mesh.pad_rows``), each step's sorted batch split into one slice
        a rank, the pair hash set on every rank, dense masked updates."""
        mesh = self.mesh
        n, p = mesh.num_devices, mesh.rank
        if self.update_mode == "sparse":
            warnings.warn(
                "update_mode='sparse' applies to the single-device path "
                "only; the sharded epoch uses dense masked updates (each "
                "rank's update buffer is its table shard, already "
                "O(rows/ranks) memory)", stacklevel=3)
        self.update_mode_ = "dense"
        dev = self.device
        U, I = X.shape
        Bn = u2.shape[1] // n
        N = self._samples_per_epoch
        self.last_loss = None
        coo = X.tocoo()
        hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
        opt = make_optimizer(self.optimizer, self.learning_rate)
        W, H, ow, oh, start_epoch = _sharded_batch_state(
            self, mesh, opt, U, I, checkpoint_path, resume)
        u_d = torch.from_numpy(np.ascontiguousarray(
            u2[:, p * Bn:(p + 1) * Bn])).to(dev)
        i_d = torch.from_numpy(np.ascontiguousarray(
            i2[:, p * Bn:(p + 1) * Bn])).to(dev)

        def publish():
            self._state = {"W": W, "H": H, "ow": ow, "oh": oh}
            self._sharded_keys = frozenset(self._state)

        def run(epoch):
            return sharded_bpr_epoch(
                mesh, W, H, ow, oh, u_d, i_d, hs, N,
                epoch_generator(seed, epoch, dev), optimizer=opt,
                weight_decay=self.weight_decay, num_users=U, num_items=I,
                draw=_draw_negatives)

        self._run_device_epochs(num_epochs, verbose, None, run, publish,
                                checkpoint_path, checkpoint_every,
                                start_epoch)

    def _fit_packed_sharded(self, X, u2, i2, num_epochs, verbose, seed,
                            checkpoint_path, checkpoint_every, resume):
        """The packed engine on a mesh, as ``cymf_tpu.BPR.
        _fit_packed_sharded``: this rank's row shard of the packed W (rows
        padded to ``256 * n``, so a shard is whole windows), the whole
        logical H, the rank's contiguous slice of every step
        (``prep_shard_static``), the whole epoch's negatives drawn on
        every rank and sliced (``prep_shard_epoch``), pipeline v4 with one
        all-reduce of the item-side sums a step
        (:func:`~cymf_tpu_torch.parallel.shard_step.sharded_packed_bpr_epoch`)."""
        mesh = self.mesh
        n, p = mesh.num_devices, mesh.rank
        self.prep_backend_ = prep_backend()
        _cap_prep_threads(mesh)
        dev = self.device
        U, I = X.shape
        K = self.num_components
        N = self._samples_per_epoch
        self.last_loss = None
        wrows_w, wrows_h = 256, 256
        rw = pk.packed_rows(U, K, multiple=wrows_w * n)
        rh = pk.logical_rows(I, multiple=wrows_h)
        # the sharded engine runs the span-independent v4 pipeline
        self.packed_kernel_ = 4
        (u_loc, i_loc, winw, si, rowsi, wini, starts, counts, Bd) = \
            prep_shard_static(u2, i2, K, rw, rh, wrows_w, wrows_h, n,
                              shard=p)
        coo = X.tocoo()
        pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
        key_filter = make_reject_filter(pos_keys, U, I)
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        Wf = _put(pk.pack_array(self.W, K, multiple=wrows_w * n), "cpu")
        Hp = _put(pk.pack_logical(self.H, K, multiple=wrows_h), dev)
        owf, oh = opt.init(Wf), opt.init(Hp)
        flat, start_epoch = _resume_point(checkpoint_path, resume)
        mesh.agree(start_epoch, "the checkpoint's epoch")
        if flat is not None:
            Wf, Hp, owf, oh = _packed_resume_state(
                flat, U, I, K, wrows_w * n, wrows_h, owf, oh, "cpu")
            Hp = Hp.to(dev)
        Wp = mesh.put_table(Wf, torch.float32)
        ow = {k: mesh.put_table(v, torch.float32) for k, v in owf.items()}

        def put(a):  # this rank's streams, the shard axis dropped
            return torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)

        static = [put(a) for a in (u_loc, i_loc, si, rowsi, wini)]
        winw_d = put(winw)
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows_w=wrows_w, wrows_h=wrows_h)

        def publish():
            self._state = {"W": unpack_device(Wp, K), "H": Hp[:, :K],
                           "owp": ow, "ohp": oh}
            self._sharded_keys = frozenset({"W", "owp"})

        def prep(epoch):
            j2, mask, _, _, _ = prep_epoch(
                np.random.default_rng((seed, epoch)), u2, i2, pos_keys, U,
                I, K, rh, wrows_h, native_seed=seed * 1_000_003 + epoch,
                key_filter=key_filter, sides=False)
            return prep_shard_epoch(j2, mask, starts, counts, Bd, rh,
                                    wrows_h, n, shard=p)

        def run(epoch, *streams):
            return sharded_packed_bpr_epoch(
                mesh, Wp, Hp, ow, oh, *static, *(put(a) for a in streams),
                winw_d, N, **kw)

        self._run_device_epochs(num_epochs, verbose, prep, run, publish,
                                checkpoint_path, checkpoint_every,
                                start_epoch)

    def _fit_wide_sharded(self, X, u2, i2, num_epochs, verbose, seed,
                          checkpoint_path, checkpoint_every, resume):
        """The wide engine (K >= 128) on a mesh, as ``cymf_tpu.BPR.
        _fit_wide_sharded``: this rank's row shard of the wide W (rows
        padded to ``512 * n``), the whole wide H, the rank's slice of
        every step, one all-reduce of ``(rh, Kp + 128)`` a step
        (:func:`~cymf_tpu_torch.parallel.shard_step.sharded_wide_bpr_epoch`)."""
        mesh = self.mesh
        n, p = mesh.num_devices, mesh.rank
        self.prep_backend_ = prep_backend()
        _cap_prep_threads(mesh)
        dev = self.device
        U, I = X.shape
        K = self.num_components
        N = self._samples_per_epoch
        self.last_loss = None
        wrows = 512
        rw, rh = wide_rows(U, wrows * n), wide_rows(I, wrows)
        (u_loc, rowsu, winw, i_loc, si, rowsi, wini, starts, counts,
         Bd) = prep_shard_static_wide(u2, i2, rw, rh, wrows, n, shard=p)
        coo = X.tocoo()
        pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
        key_filter = make_reject_filter(pos_keys, U, I)
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        Wf = _put(pack_wide(self.W, K, multiple=wrows * n), "cpu")
        Hd = _put(pack_wide(self.H, K, multiple=wrows), dev)
        owf, oh = opt.init(Wf), opt.init(Hd)
        flat, start_epoch = _resume_point(checkpoint_path, resume)
        mesh.agree(start_epoch, "the checkpoint's epoch")
        if flat is not None:
            Wf, Hd, owf, oh = _wide_resume_state(
                flat, U, I, K, wrows * n, wrows, owf, oh, "cpu")
            Hd = Hd.to(dev)
        Wd = mesh.put_table(Wf, torch.float32)
        ow = {k: mesh.put_table(v, torch.float32) for k, v in owf.items()}

        def put(a):  # this rank's streams, the shard axis dropped
            return torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)

        static = [put(a) for a in (u_loc, i_loc, rowsu, winw, si, rowsi,
                                   wini)]
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows=wrows)

        def publish():
            self._state = {"W": Wd[:, :K], "H": Hd[:, :K], "oww": ow,
                           "ohw": oh}
            self._sharded_keys = frozenset({"W", "oww"})

        def prep(epoch):
            j2, mask, _, _, _ = prep_epoch(
                np.random.default_rng((seed, epoch)), u2, i2, pos_keys, U,
                I, K, rh, wrows, native_seed=seed * 1_000_003 + epoch,
                key_filter=key_filter, sides=False)
            j_loc, mf, sj, rowsj, winj = prep_shard_epoch(
                j2, mask, starts, counts, Bd, rh, wrows, n, shard=p)
            return (j_loc, mf, sj, rowsj, winj,
                    *wide_shard_masks(mf, si, sj))

        def run(epoch, *streams):
            return sharded_wide_bpr_epoch(
                mesh, Wd, Hd, ow, oh, *static, *(put(a) for a in streams),
                N, **kw)

        self._run_device_epochs(num_epochs, verbose, prep, run, publish,
                                checkpoint_path, checkpoint_every,
                                start_epoch)

    def _fit_batch(self, X, u2, i2, num_epochs, verbose, seed,
                   checkpoint_path, checkpoint_every, resume):
        """The portable batch engine (:func:`_bpr_epoch`), as the
        single-device branch of ``cymf_tpu.BPR.fit``: logical tables, the
        pair hash set on the device, ``mode`` from ``3 * B`` rows against
        the tables', one ``torch.Generator`` an epoch
        (``ops/relmf_epoch.py::epoch_generator``)."""
        dev = self.device
        U, I = X.shape
        B = u2.shape[1]
        N = self._samples_per_epoch
        self.last_loss = None
        coo = X.tocoo()
        hs = to_device(build_pair_hashset(coo.row, coo.col), dev)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # copies in the param dtype: the host tables must not see the
        # in-place updates
        W = torch.tensor(self.W, dtype=config.param_dtype(), device=dev)
        H = torch.tensor(self.H, dtype=config.param_dtype(), device=dev)
        self.update_mode_ = choose_update_mode(self.update_mode, 3 * B,
                                               U + I)
        opt = make_optimizer(self.optimizer, self.learning_rate)
        ow, oh = opt.init(W), opt.init(H)
        flat, start_epoch = _resume_point(checkpoint_path, resume)
        if flat is not None:
            W, H, ow, oh = _batch_resume_state(flat, U, I,
                                               self.num_components, ow, oh,
                                               dev)
        u_d, i_d = put(u2), put(i2)

        def publish():
            self._state = {"W": W, "H": H, "ow": ow, "oh": oh}

        def run(epoch):
            return _bpr_epoch(
                W, H, ow, oh, u_d, i_d, hs, N,
                epoch_generator(seed, epoch, dev), optimizer=opt,
                weight_decay=self.weight_decay, num_users=U, num_items=I,
                update_mode=self.update_mode_)

        self._run_device_epochs(num_epochs, verbose, None, run, publish,
                                checkpoint_path, checkpoint_every,
                                start_epoch)

    def _fit_packed(self, X, u2, i2, num_epochs, verbose, seed,
                    checkpoint_path, checkpoint_every, resume):
        """Packed tables + fused kernels + sorted accumulations with
        host-side negative streams; the pipeline as ``prep_static`` (or,
        with ``neg_pool``, v8) picks it.  Under ``CYMF_TPU_BPR_PREP=device``
        the negative side is drawn, rejected and sorted on the device
        (pipeline v4, no host work an epoch)."""
        prep_env = os.environ.get("CYMF_TPU_BPR_PREP", "host")
        if prep_env not in ("host", "device"):
            raise ValueError("CYMF_TPU_BPR_PREP must be host|device")
        if prep_env == "device" and self.neg_pool:
            raise ValueError(
                "CYMF_TPU_BPR_PREP=device conflicts with neg_pool (the "
                "pool engine's shared draws are host-prepared); unset "
                "one of them")
        device_prep = prep_env == "device"
        # which stream the negatives come from (native mt19937_64 or numpy
        # PCG64, or the device's generator); host prep raises if the
        # native library cannot be built
        self.prep_backend_ = "device-torch" if device_prep \
            else prep_backend()
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
            # pool prep draws from the numpy stream alone; the native
            # library only tests membership, bit-identically
            self.prep_backend_ = "numpy"
        else:
            winw, wstart, si, rowsi, wini, bcs, bcn, kernel_v = \
                prep_static(u2, i2, K, rw, rh, wrows_w, wrows_h)
        if device_prep:
            # the device epoch runs the span-independent v4 (v5/v6 need
            # host-computed expansion starts)
            kernel_v = 4
        # which pipeline runs (8/6/5/4, data-dependent; 7 when forced)
        self.packed_kernel_ = kernel_v
        coo = X.tocoo()
        if device_prep:
            hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
        else:
            pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
            # once per fit: the rejection filter of both prep streams
            key_filter = make_reject_filter(pos_keys, U, I)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Wp = put(pk.pack_array(self.W, K, multiple=wrows_w))
        Hp = put(pk.pack_logical(self.H, K, multiple=wrows_h))
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        ow, oh = opt.init(Wp), opt.init(Hp)
        flat, start_epoch = _resume_point(checkpoint_path, resume)
        if flat is not None:
            Wp, Hp, ow, oh = _packed_resume_state(flat, U, I, K, wrows_w,
                                                  wrows_h, ow, oh, dev)
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

        def prep(epoch):
            rng = np.random.default_rng((seed, epoch))
            if kernel_v == 8:
                pool2, _, mask, _ = prep_pool_epoch(
                    rng, u2, pos_keys, U, I, self.neg_pool, r2=r2_fit,
                    key_filter=key_filter)
                return pool2, mask
            return prep_epoch(rng, u2, i2, pos_keys, U, I, K, rh, wrows_h,
                              native_seed=seed * 1_000_003 + epoch,
                              key_filter=key_filter)

        def run_device(epoch):
            return packed_bpr_epoch_device(
                Wp, Hp, ow, oh, *static, winw_d, hs,
                epoch_generator(seed, epoch, dev), N, num_users=U,
                num_items=I, **kw)

        def run(epoch, *streams):
            if kernel_v == 8:
                pool2, mask = streams
                return packed_bpr_pool_epoch(
                    Wp, Hp, ow, oh, *static, put(pool2), rjs_d, put(mask),
                    winw_d, N, **kw)
            return packed_bpr_epoch(
                Wp, Hp, ow, oh, *static, *(put(a) for a in streams), winw_d,
                *blocks, N, kernel_v=kernel_v, **kw)

        self._run_device_epochs(
            num_epochs, verbose, None if device_prep else prep,
            run_device if device_prep else run, publish, checkpoint_path,
            checkpoint_every, start_epoch)

    def _fit_wide(self, X, u2, i2, num_epochs, verbose, seed,
                  checkpoint_path, checkpoint_every, resume):
        """Wide tables (K >= 128) + the count-lane sorted accumulations,
        as ``cymf_tpu.BPR._fit_wide``: 512-row windows on both sides, the
        prep streams of the packed engine."""
        self.prep_backend_ = prep_backend()
        dev = self.device
        U, I = X.shape
        K = self.num_components
        N = self._samples_per_epoch
        self.last_loss = None
        wrows = 512  # both sides, as the JAX package's wide engine
        rw, rh = wide_rows(U, wrows), wide_rows(I, wrows)
        rowsu, winw, si, rowsi, wini = prep_static_wide(u2, i2, rw, rh,
                                                        wrows)
        coo = X.tocoo()
        pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
        key_filter = make_reject_filter(pos_keys, U, I)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Wd = put(pack_wide(self.W, K, multiple=wrows))
        Hd = put(pack_wide(self.H, K, multiple=wrows))
        opt = make_packed_optimizer(self.optimizer, self.learning_rate)
        ow, oh = opt.init(Wd), opt.init(Hd)
        flat, start_epoch = _resume_point(checkpoint_path, resume)
        if flat is not None:
            Wd, Hd, ow, oh = _wide_resume_state(flat, U, I, K, wrows, wrows,
                                                ow, oh, dev)
        static = [put(a) for a in (u2, i2, rowsu, winw, si, rowsi, wini)]
        kw = dict(opt_name=self.optimizer, lr=self.learning_rate,
                  weight_decay=self.weight_decay, K=K, rw=rw, rh=rh,
                  wrows=wrows)

        def publish():
            self._state = {"W": Wd[:, :K], "H": Hd[:, :K], "oww": ow,
                           "ohw": oh}

        def prep(epoch):
            j2, mask, sj, rowsj, winj = prep_epoch(
                np.random.default_rng((seed, epoch)), u2, i2, pos_keys, U,
                I, K, rh, wrows, native_seed=seed * 1_000_003 + epoch,
                key_filter=key_filter)
            return (j2, mask, sj, rowsj, winj,
                    *wide_sorted_masks(mask, si, sj))

        def run(epoch, *streams):
            return wide_bpr_epoch(Wd, Hd, ow, oh, *static,
                                  *(put(a) for a in streams), N, **kw)

        self._run_device_epochs(num_epochs, verbose, prep, run, publish,
                                checkpoint_path, checkpoint_every,
                                start_epoch)

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
