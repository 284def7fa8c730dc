"""Packed-table fused BPR epochs — the single-chip fast path.

Port of `cymf_tpu/ops/packed_epoch.py` for one device.  Each step of an
epoch (a Python loop in place of ``lax.scan``) runs one of the JAX
package's kernel pipelines, picked per fit from the data by
:func:`engine_version` (:func:`prep_static` returns it):

- v4 (any data): gather the packed user rows ``Wp[u // s]`` and the
  logical item rows ``Hp[i]``, ``Hp[j]``, decorate the user rows with the
  mask-scaled slot one-hot, run the fused sample kernel
  (:func:`~.fused_sample.bpr_sample_phase`) and accumulate the W side over
  the user-sorted stream (:func:`~.sorted_accum.sorted_accum`);
- v5 (every 512-sample tile's packed rows fit a ``WROWS_A``-row window):
  the sample kernel reads the W rows itself
  (:func:`~.fused_sample.bpr_sample_phase_v5`), the decoration rides on the
  j rows, then the same W accumulation;
- v6 (every 1024-sample chunk fits ``CROWS`` rows, ``wrows_w >= CROWS``):
  one kernel does the v5 sample phase and the W accumulation
  (:func:`~.fused_step.bpr_block_step_v6`), the loss on lane 127;
- v7 (only when forced, ``CYMF_TPU_PACKED_KERNEL=7``): the v4 gathers and
  one kernel for the sample phase and the W accumulation by window
  (:func:`~.fused_step.bpr_range_step_v7`).

Every pipeline then accumulates both H sides into one buffer by the
host-computed item sort permutations
(:func:`~.sorted_accum.sorted_accum_dual`) and runs one packed optimizer
pass per table.  :func:`packed_bpr_pool_epoch` is the v8 engine of
``BPR(neg_pool=P)``: negatives from a per-step pool of ``P`` items, the
pool side summed in the kernel (:func:`~.fused_step.bpr_pool_step_v8`) and
scattered with one ``P``-row ``index_add_``.

Weight decay is rebuilt per row as ``wd * n_r * T_r`` from the live-sample
counts of the count channel, and a row is touched iff a live sample hit
it: the count-based mask of the JAX package, never a value-based one.

Host prep is the JAX package's, both of its streams: the native C++
OpenMP pipeline (:mod:`cymf_tpu_torch.native`, the mt19937_64 stream,
:func:`prep_epoch` with ``native_seed``, rejection behind the one-bit
filter of :func:`make_reject_filter`) by default, and the numpy branch
verbatim (:func:`prep_static`, :func:`prep_epoch` with the same
``default_rng((seed, epoch))`` draws, :func:`prep_static_pool`,
:func:`prep_pool_epoch`) under ``CYMF_TPU_PREP=numpy``, so both packages
train on the same streams and pick the same pipeline.  The once-a-fit
static streams (:func:`prep_static`'s sorts, windows and span gates) are
the same arrays on both backends: counting sorts in the library, the
numpy code under ``CYMF_TPU_PREP=numpy``.

Device prep (:func:`packed_bpr_epoch_device`, ``CYMF_TPU_BPR_PREP=device``)
draws, rejects, sorts and windows each step's negatives on the tables'
device and runs the v4 step body (:func:`bpr_v4_step`) that host prep runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import os

from .. import native
from . import packed as pk
from .fused_sample import (TILE as SAMPLE_TILE, WROWS_A, bpr_sample_phase,
                           bpr_sample_phase_v5, decorate)
from .fused_step import (CROWS, LOSS_LANE, bpr_block_step_v6,
                         bpr_pool_step_v8, bpr_range_step_v7, prep_blocks,
                         supports_v6, supports_v7)
from .sorted_accum import sorted_accum, sorted_accum_dual, window_ranges
from .hashset import PairHashSet, hashset_contains
from ..utils.profiling import count

# window-range alignment tile of the JAX package's default
# (CYMF_TPU_ACCUM_TILE); the CUDA kernels do not need it, but the host
# streams stay identical to the JAX package's with it
TILE = 1024


def unpack_device(Tp: torch.Tensor, K: int) -> torch.Tensor:
    """(R, 128) packed table -> (R*s, K) logical rows (a copy)."""
    s = pk.num_slots(K)
    R = Tp.shape[0]
    return Tp[:, : s * K].reshape(R * s, K)


class PackedAdam:
    """Adam over packed tables with per-logical-row touched masking and a
    constant bias correction (parity quirk, `optimizer.pyx:150-160`).
    ``mask`` is True on every payload lane of a row that at least one live
    sample hit.  :meth:`update` overwrites the table and the moments IN
    PLACE."""

    def __init__(self, alpha, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.alpha, self.beta1, self.beta2, self.epsilon = \
            float(alpha), float(beta1), float(beta2), float(epsilon)

    def init(self, Tp):
        return {"m": torch.zeros_like(Tp), "v": torch.zeros_like(Tp)}

    def update(self, Tp, state, gbuf, mask):
        m, v = state["m"], state["v"]
        m.copy_(torch.where(mask, self.beta1 * m
                            + (1.0 - self.beta1) * gbuf, m))
        v.copy_(torch.where(mask, self.beta2 * v
                            + (1.0 - self.beta2) * torch.square(gbuf), v))
        delta = torch.where(
            mask, -self.alpha * (m / (1.0 - self.beta1))
            / (torch.sqrt(v / (1.0 - self.beta2)) + self.epsilon), 0.0)
        Tp.add_(delta)


class PackedAdaGrad:
    """AdaGrad, ones-init accumulators (`optimizer.pyx:69-82`).  A zero
    gradient is a no-op, so no mask is needed.  Updates IN PLACE."""

    def __init__(self, lr):
        self.lr = float(lr)

    def init(self, Tp):
        return {"accum": torch.ones_like(Tp)}

    def update(self, Tp, state, gbuf, mask):
        accum = state["accum"]
        accum.add_(torch.square(gbuf))
        Tp.sub_(self.lr * gbuf * torch.rsqrt(accum))


class PackedSgd:
    """Plain SGD.  Updates IN PLACE."""

    def __init__(self, lr):
        self.lr = float(lr)

    def init(self, Tp):
        return {}

    def update(self, Tp, state, gbuf, mask):
        Tp.sub_(self.lr * gbuf)


def make_packed_optimizer(name, lr):
    if name == "adam":
        return PackedAdam(alpha=lr)
    if name == "adagrad":
        return PackedAdaGrad(lr)
    if name == "sgd":
        return PackedSgd(lr)
    raise Exception(f"{name} is invalid.")


def _pad_lanes(a: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, pk.LANES - a.shape[1]))


def _update_w(opt, Wp, ow, Aw, K: int, wd: float) -> None:
    """The W table's optimizer pass from its accumulated step sums."""
    cb = pk.count_base(K)
    gw, nw = pk.split_counts(Aw, K)
    nwE = pk.expand_counts(nw, K)
    opt.update(Wp, ow, _pad_lanes(-gw + wd * nwE * Wp[:, :cb]),
               _pad_lanes(nwE > 0))


def _update_h(opt, Hp, oh, D, K: int, wd: float) -> None:
    """The logical H table's optimizer pass from ``D = Aj - Ai`` on the
    payload lanes with the live counts summed at lane ``K``."""
    payb = torch.arange(pk.LANES, device=Hp.device) < K
    nh = D[:, K:K + 1]
    opt.update(Hp, oh, (D + wd * nh * Hp) * payb.to(Hp.dtype),
               (nh > 0) & payb)


@torch.no_grad()
def packed_bpr_epoch(Wp, Hp, ow, oh, u_steps, i_steps, si_steps,
                     rowsi_steps, wini, j_steps, mask_steps, sj_steps,
                     rowsj_steps, winj, winw, wstart_steps, cs_steps,
                     cn_steps, n_valid: int, *, opt_name: str, lr: float,
                     weight_decay: float, K: int, rw: int, rh: int,
                     wrows_w: int = 512, wrows_h: int = 512,
                     kernel_v: int = 4) -> torch.Tensor:
    """One epoch over S pre-sorted minibatches; returns the mean loss
    (0-d tensor, ``sum / max(n_valid, 1)`` with ``n_valid`` the sample
    count, not the live count).

    ``Wp`` (packed user table, ``rw`` rows), ``Hp`` (logical item table,
    ``rh`` rows, payload lanes ``[0, K)``) and the optimizer states
    ``ow``/``oh`` are updated IN PLACE.  The streams are device tensors
    laid out as the JAX package's:

      u_steps int32[S, B]        users, ascending within each step
                                 (padding: PAD_USER, sorts last, dropped)
      i_steps int32[S, B]        positives, aligned with u
      si_steps int32[S, B]       permutation sorting a step by item id
      rowsi_steps int32[S, B/128, 128]  folded sorted item ids
      wini int32[S, 2, rh/wrows_h]      i-side windows (starts; counts)
      j_steps int32[S, B]        negatives (host-drawn), aligned with u
      mask_steps uint8[S, B]     1 = live sample (in data, no collision)
      sj/rowsj/winj              j-side analogues of si/rowsi/wini
      winw int32[S, 2, rw/wrows_w]      W-side windows over u // s
      wstart_steps int32[S, B/512 or B/1024]  per-chunk W expansion
                                 window starts (v5, v6)
      cs_steps/cn_steps int32[S, rw/wrows_w]  per-block home chunk
                                 ranges (v6, `prep_blocks`)

    ``kernel_v`` is the pipeline :func:`prep_static` returned for these
    streams (the module docstring).
    """
    opt = make_packed_optimizer(opt_name, lr)
    wd = float(weight_decay)
    s = pk.num_slots(K)
    if kernel_v == 5 and s < 2:
        raise ValueError("kernel_v=5 requires >= 2 slots per row")
    kw = dict(K=K, wd=wd)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for t in range(u_steps.shape[0]):
        u, mf = u_steps[t], mask_steps[t].to(torch.float32)
        if kernel_v not in (5, 6, 7):
            loss += bpr_v4_step(
                Wp, Hp, ow, oh, opt, u, i_steps[t], si_steps[t],
                rowsi_steps[t], wini[t, 0], wini[t, 1], j_steps[t], mf,
                sj_steps[t], rowsj_steps[t], winj[t, 0], winj[t, 1],
                winw[t, 0], winw[t, 1], weight_decay=wd, K=K, rw=rw, rh=rh,
                wrows_w=wrows_w, wrows_h=wrows_h)
            continue
        phys_u, slot_u = u // s, u % s
        Di = Hp.index_select(0, i_steps[t])
        if kernel_v == 7:
            Du = decorate(Wp.index_select(0, phys_u.clamp(max=rw - 1)),
                          slot_u, mf, K)
            Aw, Q = bpr_range_step_v7(phys_u, Du, Di,
                                      Hp.index_select(0, j_steps[t]),
                                      winw[t, 0], winw[t, 1], rw=rw,
                                      wrows=wrows_w, **kw)
            loss += Aw[:, LOSS_LANE].sum()
        else:
            # the W rows are read in the kernel; the mask and slot ride on
            # the j rows' count lanes
            Dj = decorate(Hp.index_select(0, j_steps[t]), slot_u, mf, K)
            if kernel_v == 6:
                Aw, Q = bpr_block_step_v6(
                    Wp, phys_u, Di, Dj, wstart_steps[t], cs_steps[t],
                    cn_steps[t], rw=rw, wrows=wrows_w, **kw)
                loss += Aw[:, LOSS_LANE].sum()
            else:
                SW, Q, loss_t = bpr_sample_phase_v5(
                    Wp, wstart_steps[t], phys_u, Di, Dj, **kw)
                loss += loss_t
                Aw = sorted_accum(phys_u, SW, winw[t, 0], winw[t, 1],
                                  r_pad=rw, wrows=wrows_w)
        _update_w(opt, Wp, ow, Aw, K, wd)
        _update_h_dual(opt, Hp, oh, Q, si_steps[t], rowsi_steps[t],
                       wini[t, 0], wini[t, 1], sj_steps[t], rowsj_steps[t],
                       winj[t, 0], winj[t, 1], K=K, wd=wd, rh=rh,
                       wrows_h=wrows_h)
    return loss / max(int(n_valid), 1)


def _update_h_dual(opt, Hp, oh, Q, si, rowsi, wi_starts, wi_counts, sj,
                   rowsj, wj_starts, wj_counts, *, K: int, wd: float,
                   rh: int, wrows_h: int, reduce_h=None) -> None:
    """The logical H table's step: one dual-stream accumulation of ``Q``
    by both item sorts yields ``D = Aj - Ai`` on the payload lanes with the
    live counts summed at lane ``K``, then the optimizer pass.  Between
    the two, ``reduce_h(D)`` (when given) sums ``D`` over the ranks in
    place: the sharded epoch's one collective a step."""
    D = sorted_accum_dual(
        rowsi, Q.index_select(0, si), wi_starts, wi_counts, rowsj,
        Q.index_select(0, sj), wj_starts, wj_counts, r_pad=rh, neg_lanes=K,
        wrows=wrows_h)
    if reduce_h is not None:
        reduce_h(D)
    _update_h(opt, Hp, oh, D, K, wd)


def bpr_v4_step(Wp, Hp, ow, oh, opt, u, i, si, rowsi, wi_starts, wi_counts,
                j, mf, sj, rowsj, wj_starts, wj_counts, ww_starts, ww_counts,
                *, weight_decay: float, K: int, rw: int, rh: int,
                wrows_w: int, wrows_h: int, reduce_h=None) -> torch.Tensor:
    """One v4 step over ``B`` user-sorted samples; updates ``Wp``, ``Hp``
    and their optimizer states IN PLACE and returns the step's loss sum
    (0-d tensor).  Host and device prep both run this body, and so does
    the sharded epoch (``parallel/shard_step.py``) on a rank's row shard
    of ``Wp`` (``rw`` its rows) with ``reduce_h`` its all-reduce of the
    item-side sums (:func:`_update_h_dual`).

    ``u``/``i``/``j`` are int32 (B,) users (ascending; padding
    ``PAD_USER``), positives and negatives, ``mf`` the float32 live mask,
    ``si``/``rowsi``/``wi_*`` and ``sj``/``rowsj``/``wj_*`` each item
    side's sort permutation, sorted rows (any shape with ``B`` elements)
    and windows, ``ww_*`` the W side's windows over ``u // s``: the W-row
    gather and its decoration, the fused sample kernel
    (:func:`~.fused_sample.bpr_sample_phase`), the W accumulation and
    optimizer pass, then the dual H accumulation and its pass."""
    wd = float(weight_decay)
    s = pk.num_slots(K)
    phys_u = u // s
    # clamp only the gather index: padding sentinels stay >= rw so the
    # accumulation drops them, and the kernel mask-zeroes their values
    Du = decorate(Wp.index_select(0, phys_u.clamp(max=rw - 1)), u % s, mf,
                  K)
    SW, Q, loss = bpr_sample_phase(Du, Hp.index_select(0, i),
                                   Hp.index_select(0, j), K=K, wd=wd)
    Aw = sorted_accum(phys_u, SW, ww_starts, ww_counts, r_pad=rw,
                      wrows=wrows_w)
    _update_w(opt, Wp, ow, Aw, K, wd)
    _update_h_dual(opt, Hp, oh, Q, si, rowsi, wi_starts, wi_counts, sj,
                   rowsj, wj_starts, wj_counts, K=K, wd=wd, rh=rh,
                   wrows_h=wrows_h, reduce_h=reduce_h)
    return loss


def draw_negatives(gen: torch.Generator, B: int,
                   num_items: int) -> torch.Tensor:
    """One device-prep step's ``B`` uniform negatives over ``[0,
    num_items)``, int32 on ``gen``'s device: :func:`packed_bpr_epoch_device`'s
    only draw."""
    return torch.randint(0, num_items, (B,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def row_dot(a: torch.Tensor, b: torch.Tensor,
            keepdim: bool = False) -> torch.Tensor:
    """``sum(a * b, dim=1)`` as the batch engines take it: in a reduced
    dtype (a bfloat16 param dtype) the products and their sum in float32,
    rounded once to ``a``'s dtype, as XLA computes a product fused into a
    row sum; in float32 the plain sum."""
    return torch.sum(a.float() * b.float(), dim=1,
                     keepdim=keepdim).to(a.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``sigmoid(x)`` as the batch engines take it: ``torch.sigmoid`` in
    float32; in a reduced dtype (a bfloat16 param dtype) ``1 / (1 +
    exp(-x))`` rounded op by op, as XLA expands ``jax.nn.sigmoid`` there
    (``torch.sigmoid`` rounds once, and differs in the last bit)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` as the batch engines take it: ``F.logsigmoid``
    in float32; in a reduced dtype ``-(max(-x, 0) + log1p(exp(-|x|)))``
    rounded op by op, ``jax.nn.log_sigmoid``'s form."""
    if x.dtype == torch.float32:
        return F.logsigmoid(x)
    return -(torch.clamp(-x, min=0.0) + torch.log1p(torch.exp(-x.abs())))


def live_negatives(hs: PairHashSet, u: torch.Tensor, j: torch.Tensor,
                   num_users: int) -> torch.Tensor:
    """bool (B,): the sample is in data (``u < num_users``, padding users
    are not) and its negative ``j`` is not a positive of ``u`` (the pair
    hash set ``hs`` does not hold ``(u, j)``): the device form of
    :func:`_reject_mask`."""
    return (u < num_users) & ~hashset_contains(hs, u, j)


@torch.no_grad()
def packed_bpr_epoch_device(Wp, Hp, ow, oh, u_steps, i_steps, si_steps,
                            rowsi_steps, wini, winw, hs: PairHashSet, gen,
                            n_valid: int, *, opt_name: str, lr: float,
                            weight_decay: float, K: int, rw: int, rh: int,
                            num_users: int, num_items: int,
                            wrows_w: int = 256,
                            wrows_h: int = 256) -> torch.Tensor:
    """The v4 epoch with the negative side prepared on the tables' device
    (``CYMF_TPU_BPR_PREP=device``; the JAX package's
    ``packed_bpr_epoch_device_j``).  Each step draws its negatives from
    ``gen`` (:func:`draw_negatives`), masks padding users and the pairs the
    hash set ``hs`` holds (:func:`live_negatives`; tensors on the device,
    :func:`~.hashset.to_device`), sorts them and builds their windows
    (:func:`~.relmf_epoch._sorted_side_device`), then runs
    :func:`bpr_v4_step`.  The u/i streams and their sort sides are static
    for the fit (:func:`prep_static`), so an epoch does no host work and
    no upload, and the step makes no host sync.  The JAX package's
    2048-step spans (a relay workaround) are left out: one loop runs the
    epoch.  Updates IN PLACE; returns the mean loss."""
    from .relmf_epoch import _sorted_side_device

    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    B = u_steps.shape[1]
    for t in range(u_steps.shape[0]):
        u = u_steps[t]
        j = draw_negatives(gen, B, num_items)
        mf = live_negatives(hs, u, j, num_users).to(torch.float32)
        sj, rowsj, wj_starts, wj_counts = _sorted_side_device(j, rh, wrows_h)
        loss += bpr_v4_step(
            Wp, Hp, ow, oh, opt, u, i_steps[t], si_steps[t], rowsi_steps[t],
            wini[t, 0], wini[t, 1], j, mf, sj, rowsj, wj_starts, wj_counts,
            winw[t, 0], winw[t, 1], weight_decay=weight_decay, K=K, rw=rw,
            rh=rh, wrows_w=wrows_w, wrows_h=wrows_h)
    return loss / max(int(n_valid), 1)


@torch.no_grad()
def packed_bpr_pool_epoch(Wp, Hp, ow, oh, u_steps, i_steps, si_steps,
                          rowsi_steps, wini, pool_steps, rj_steps,
                          mask_steps, winw, n_valid: int, *, opt_name: str,
                          lr: float, weight_decay: float, K: int, rw: int,
                          rh: int, wrows_w: int = 512,
                          wrows_h: int = 512) -> torch.Tensor:
    """Shared-negative-pool epoch (``BPR(neg_pool=P)``, pipeline v8).

    Draws each step's negatives from a P-item pool: ``j[b] =
    pool[rj[b]]``, marginally uniform over the catalog, but a step's
    samples share P candidate items.  The negative-side gather, its
    reorder and the j half of the dual accumulation become the v8 kernel's
    pool reads and pool sum (:func:`~.fused_step.bpr_pool_step_v8`), plus
    one P-row gather and one P-row ``index_add_`` a step.

      pool_steps int32[S, P]   per-step pool item ids
      rj_steps int32[S, B/128, 128]  folded per-sample pool slots
      mask_steps uint8[S, B]   1 = live (in data, pool draw no collision)

    The other streams and the optimizer pass are :func:`packed_bpr_epoch`'s
    (``winw`` from :func:`prep_static_pool`).  Updates IN PLACE; returns
    the mean loss.
    """
    opt = make_packed_optimizer(opt_name, lr)
    wd = float(weight_decay)
    s = pk.num_slots(K)
    lane = torch.arange(pk.LANES, device=Wp.device)
    sv_neg = torch.where(lane < K, -1.0, 1.0)[None, :]
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for t in range(u_steps.shape[0]):
        u, mf = u_steps[t], mask_steps[t].to(torch.float32)
        phys_u, slot_u = u // s, u % s
        Du = decorate(Wp.index_select(0, phys_u.clamp(max=rw - 1)), slot_u,
                      mf, K)
        pool = pool_steps[t]
        Aw, Apool, Q = bpr_pool_step_v8(
            phys_u, rj_steps[t], Du, Hp.index_select(0, i_steps[t]),
            Hp.index_select(0, pool), winw[t, 0], winw[t, 1], K=K, wd=wd,
            rw=rw, wrows=wrows_w)
        loss += Aw[:, LOSS_LANE].sum()
        _update_w(opt, Wp, ow, Aw, K, wd)

        # H side: the i stream by sorted accumulation, the pool stream by
        # one P-row scatter-add (ids outside the table drop, as the JAX
        # scatter's mode="drop"); D is sorted_accum_dual's Aj - Ai
        Ai = sorted_accum(rowsi_steps[t], Q.index_select(0, si_steps[t]),
                          wini[t, 0], wini[t, 1], r_pad=rh, wrows=wrows_h)
        inside = (pool >= 0) & (pool < rh)
        Aj = torch.zeros_like(Ai).index_add_(
            0, pool.clamp(0, rh - 1).long(), Apool * inside[:, None])
        _update_h(opt, Hp, oh, Aj + Ai * sv_neg, K, wd)
    return loss / max(int(n_valid), 1)


# ---------------------------------------------------------------------------
# host-side preparation (numpy, as in the JAX package; the once-a-fit
# sorts and windows in the native library under the native backend)
# ---------------------------------------------------------------------------

def _sorted_side(vals2, r_pad, wrows, tile):
    """Per-step sort permutation + folded sorted rows + windows for one
    H side (``vals2`` = item ids, int [S, B]).  The H table is stored in
    LOGICAL layout, so the target row IS the item id.

    Under the native backend (:func:`prep_backend`) one counting-sort pass
    of the library computes the same arrays (:func:`native.sorted_side`)
    and counts its steps as ``native_steps`` on the open span; under
    ``CYMF_TPU_PREP=numpy`` the numpy body below runs and counts 0."""
    S, B = vals2.shape
    if prep_backend() == "native":
        out = native.sorted_side(vals2, r_pad, wrows, tile)
        count("native_steps", S)
        return out
    count("native_steps", 0)
    perm = np.empty((S, B), np.int32)
    rows = np.empty((S, B // 128, 128), np.int32)
    win = np.empty((S, 2, r_pad // wrows), np.int32)
    for t in range(S):
        p = np.argsort(vals2[t], kind="stable").astype(np.int32)
        perm[t] = p
        srt = vals2[t][p]
        win[t, 0], win[t, 1] = window_ranges(srt, r_pad, wrows, tile,
                                             align=128)
        rows[t] = srt.reshape(B // 128, 128)
    return perm, rows, win


def _packed_windows(u2, s: int, rw: int, wrows: int, tile: int):
    """Per-step windows of a lane-packed side over its sorted physical
    rows ``u2 // s`` (``u2`` int [S, B], ascending within each step):
    int32 ``[S, 2, rw / wrows]``; by the library's binary searches under
    the native backend (:func:`native.sorted_windows`)."""
    if prep_backend() == "native":
        return native.sorted_windows(u2, s, rw, wrows, tile)
    S = u2.shape[0]
    win = np.empty((S, 2, rw // wrows), np.int32)
    for t in range(S):
        pu = np.minimum(u2[t].astype(np.int64) // s, np.iinfo(np.int32).max)
        win[t, 0], win[t, 1] = window_ranges(pu, rw, wrows, tile, align=128)
    return win


def prep_backend() -> str:
    """Which epoch-prep stream :func:`prep_epoch` draws: ``"native"`` (the
    C++ OpenMP pipeline, mt19937_64) or ``"numpy"`` (PCG64);
    ``CYMF_TPU_PREP=numpy`` forces the numpy stream, as in the JAX
    package.

    Unlike the JAX package, which falls back to numpy when its extension
    is absent, this raises ``RuntimeError`` with the compiler's output when
    the native library cannot be built or loaded: a fit would otherwise
    draw another stream than the one asked for, and run many times slower,
    without a word.  ``CYMF_TPU_PREP=numpy`` is the one way to the numpy
    stream."""
    if os.environ.get("CYMF_TPU_PREP", "").lower() == "numpy":
        return "numpy"
    native.lib()
    return "native"


def make_reject_filter(pos_keys, num_users: int, num_items: int):
    """One-per-fit rejection acceleration state for :func:`_reject_mask`
    and the native :func:`prep_epoch`: ``(keys, filter_bits, indptr,
    log2_bits)``, a one-bit hash filter over the sorted positive keys
    (~16 bits a key) and the per-user indptr of the exact fallback.
    ``None`` when there are no keys, or under ``CYMF_TPU_PREP=numpy``
    (the numpy path then runs and the library need not build)."""
    if len(pos_keys) == 0 or prep_backend() == "numpy":
        return None
    keys = np.ascontiguousarray(pos_keys, np.int64)
    log2_bits = int(np.clip(int(np.ceil(np.log2(len(keys) * 16))), 10, 33))
    filt = native.build_key_filter(keys, log2_bits)
    return keys, filt, _user_indptr(keys, num_users, num_items), log2_bits


def _user_indptr(keys, num_users: int, num_items: int) -> np.ndarray:
    """Each user's range of the sorted keys ``u * num_items + i``: int64
    ``[num_users + 1]``."""
    return np.searchsorted(
        keys, np.arange(num_users + 1, dtype=np.int64)
        * num_items).astype(np.int64)


def _reject_mask(u2, j2, pos_keys, num_users: int, num_items: int,
                 key_filter=None):
    """``1`` (uint8) where the sample is in-data and ``(u, j)`` is not a
    known positive (``pos_keys``: sorted ``u * num_items + i``).  The
    membership test runs in the native library unless
    ``CYMF_TPU_PREP=numpy``: behind ``key_filter``'s filter when given,
    else by per-user ranges of the keys; both equal the numpy path bit
    for bit, which stays the only source of draws."""
    if prep_backend() == "native":
        u2c = np.ascontiguousarray(u2, np.int32)
        j2c = np.ascontiguousarray(j2, np.int32)
        if key_filter is not None:
            keys, filt, indptr, log2_bits = key_filter
            m = native.pool_reject_v3(u2c, j2c, keys, indptr, filt, u2c.size,
                                      num_users, num_items, log2_bits)
        else:
            keys = np.ascontiguousarray(pos_keys, np.int64)
            m = native.pool_reject_v2(
                u2c, j2c, keys, _user_indptr(keys, num_users, num_items),
                u2c.size, num_users, num_items)
        return m.reshape(u2.shape).astype(np.uint8)
    u64 = u2.astype(np.int64)
    in_data = u64 < num_users
    keys = u64 * num_items + j2
    idx = np.searchsorted(pos_keys, keys)
    idx = np.minimum(idx, max(len(pos_keys) - 1, 0))
    collide = (pos_keys[idx] == keys) if len(pos_keys) else \
        np.zeros_like(keys, bool)
    return (in_data & ~collide).astype(np.uint8)


def _spans_fit(pu2, stride: int, margin: int, rw: int) -> bool:
    """True iff EVERY `stride`-sample chunk of every step's (sorted)
    packed-row stream fits a `margin`-row expansion window anchored at
    its first row (clipped to ``rw - margin``).  The naive bound
    "a chunk of `stride` sorted samples spans <= ceil(stride/s)+1 rows"
    only holds when the chunk's users are CONSECUTIVE — a sparse batch
    (users absent from this step) has gaps, and a chunk's row span is
    unbounded.  Samples outside the window would silently expand to a
    zero W row (wrong gradients), so the engine version gate is DATA
    dependent; chunked streams that do not fit fall back to the
    W-gather pipeline (v4), which is span-independent.

    Padding samples (PAD_USER sentinel — rows >= rw, sorted last) are
    excluded: their one-hot never matches and their mask is 0, so their
    expanded values are irrelevant."""
    S, B = pu2.shape
    ch = pu2.reshape(S, B // stride, stride)
    first = ch[:, :, 0]
    # per-chunk max over in-table rows only (-1 when the chunk is all
    # padding — trivially fits)
    lastv = np.where(ch < rw, ch, -1).max(axis=2)
    return bool(np.all((lastv - first < margin) | (first > rw - margin)
                       | (lastv < 0)))


def engine_version(K: int, rw: int, wrows_w: int, u2=None,
                   tile: int = TILE) -> int:
    """Which fused kernel pipeline the packed engine runs for THESE
    batches: 6 (fused sample + W-accumulation block kernel — needs chunk
    row spans to fit), 5 (in-kernel W expansion sample kernel + separate
    accumulation — needs spans to fit), 7 (fused sample + W-accumulation
    over a GATHERED Du stream — span-independent), or 4 (W gather +
    sample kernel + separate accumulation — always available).  ``u2`` is
    the [S, B] sorted user stream; without it only the static gates apply
    (shape-only callers).  The JAX package's switches, read the same way:
    ``CYMF_TPU_PACKED_KERNEL=4|5|6|7`` forces (5/6/7 still subject to
    their correctness gates), ``CYMF_TPU_PACKED_V6=0`` disables v6.  v7 is
    taken only when forced, as in the JAX package (its TPU measurement
    found it slower than v4).  The span gates run in the library under
    the native backend (:func:`native.spans_fit`), else in numpy."""
    s = pk.num_slots(K)
    forced = os.environ.get("CYMF_TPU_PACKED_KERNEL", "")
    no_v6 = os.environ.get("CYMF_TPU_PACKED_V6", "").lower() in (
        "0", "off", "false") or forced in ("4", "5", "7")
    if forced == "4":
        return 4
    if u2 is None:
        def fits(stride, margin):
            return True
    elif prep_backend() == "native":
        def fits(stride, margin):
            return native.spans_fit(u2, s, stride, margin, rw)
    else:
        pu2 = np.minimum(np.asarray(u2).astype(np.int64) // s,
                         np.iinfo(np.int32).max)

        def fits(stride, margin):
            return _spans_fit(pu2, stride, margin, rw)
    if not no_v6 and supports_v6(K, rw, wrows_w) and fits(tile, CROWS):
        return 6
    wrows_a = min(WROWS_A, rw)
    if forced != "7" and s >= 2 \
            and wrows_a >= min(-(-SAMPLE_TILE // s) + 1, rw) \
            and fits(SAMPLE_TILE, wrows_a):
        return 5
    if forced == "7" and supports_v7(K, rw, wrows_w):
        return 7
    return 4


def _reanchor_last(winw_t, B: int, tile: int) -> None:
    """v7/v8: the last window's range extends over the padding tail so
    every sample's Q row gets written (mask-zeroed for padding);
    re-anchor so its chunk grid ends exactly at B."""
    nb = winw_t.shape[1]
    st = int(winw_t[0, nb - 1])
    st2 = B - -(-(B - st) // tile) * tile
    winw_t[0, nb - 1] = st2
    winw_t[1, nb - 1] = B - st2


def prep_static(u2, i2, K: int, rw: int, rh: int, wrows_w: int,
                wrows_h: int, tile: int = TILE):
    """Once per fit: W-side windows (u is pre-sorted), the per-chunk W
    expansion window starts (v5/v6 kernels), the v6 per-block home-chunk
    ranges, and the full i-side prep (batch composition is fixed across
    epochs, `bpr.pyx:104`).

    Returns ``(winw, wstart, si, rowsi, wini, cs, cn, version)`` —
    ``version`` is the data-dependent kernel version
    (:func:`engine_version`) and MUST be passed to
    :func:`packed_bpr_epoch` as ``kernel_v``."""
    S, B = u2.shape
    s = pk.num_slots(K)
    version = engine_version(K, rw, wrows_w, u2=u2, tile=tile)
    stride = tile if version == 6 else SAMPLE_TILE
    margin = CROWS if version == 6 else min(WROWS_A, rw)
    nT = B // stride if version in (5, 6) else 1
    nb = rw // wrows_w
    winw = _packed_windows(u2, s, rw, wrows_w, tile)
    wstart = np.zeros((S, nT), np.int32)
    cs = np.zeros((S, nb), np.int32)
    cn = np.zeros((S, nb), np.int32)
    for t in range(S):
        if version == 7:
            _reanchor_last(winw[t], B, tile)
        if version in (5, 6):
            # each chunk's expansion window starts at its first row
            # (spans proven to fit by the engine_version gate)
            pu = np.minimum(u2[t, ::stride].astype(np.int64) // s,
                            np.iinfo(np.int32).max)
            wstart[t] = np.clip(pu, 0, max(rw - margin, 0)).astype(np.int32)
        if version == 6:
            cs[t], cn[t] = prep_blocks(wstart[t], rw, wrows_w)
    si, rowsi, wini = _sorted_side(i2, rh, wrows_h, tile)
    return winw, wstart, si, rowsi, wini, cs, cn, version


def prep_static_pool(u2, i2, K: int, rw: int, rh: int, wrows_w: int,
                     wrows_h: int, tile: int = TILE):
    """:func:`prep_static` for the pool engine (v8): W-side windows with
    the v7-style last-window re-anchor (every sample's Q row written,
    padding mask-zeroed) plus the i-side prep.  No expansion-window /
    home-block prep — v8 is span-independent.

    Returns ``(winw, si, rowsi, wini)``."""
    S, B = u2.shape
    winw = _packed_windows(u2, pk.num_slots(K), rw, wrows_w, tile)
    for t in range(S):
        _reanchor_last(winw[t], B, tile)
    si, rowsi, wini = _sorted_side(i2, rh, wrows_h, tile)
    return winw, si, rowsi, wini


def prep_pool_epoch(rng: np.random.Generator, u2: np.ndarray,
                    pos_keys: np.ndarray, num_users: int, num_items: int,
                    P: int, r2=None, key_filter=None):
    """Per-epoch pool prep: P pool items per step (uniform, with
    replacement), per-sample pool slots, and the rejection mask — the
    pool analogue of :func:`prep_epoch`'s draws (`bpr.pyx:165-167`).
    The numpy (PCG64) stream of the JAX package's ``prep_pool_epoch``,
    whatever the backend: the native library only tests membership
    (:func:`_reject_mask`, behind ``key_filter``'s filter when given).

    ``r2`` (per-sample pool slots) may be drawn ONCE per fit and passed
    in: with a fresh uniform pool every epoch, ``j = pool_e[r]`` is
    distributionally identical whether ``r`` is redrawn or fixed.

    Returns ``(pool2 int32[S, P], rjs int32[S, B/128, 128], mask uint8,
    j2 int32[S, B])``."""
    S, B = u2.shape
    pool2 = rng.integers(0, num_items, (S, P), dtype=np.int32)
    if r2 is None:
        r2 = rng.integers(0, P, (S, B), dtype=np.int32)
    j2 = pool2[np.arange(S)[:, None], r2]
    mask = _reject_mask(u2, j2, pos_keys, num_users, num_items,
                        key_filter=key_filter)
    return pool2, r2.reshape(S, B // 128, 128), mask, j2


def prep_epoch(rng: np.random.Generator, u2: np.ndarray, i2: np.ndarray,
               pos_keys: np.ndarray, num_users: int, num_items: int, K: int,
               rh: int, wrows_h: int, tile: int = TILE, native_seed=None,
               key_filter=None, sides: bool = True):
    """Once per epoch: negative draws, rejection+padding mask, and the
    j-side sort permutation/rows/windows.  Mirrors `bpr.pyx:165-167`: one
    uniform draw per interaction, collisions with known positives masked
    out.

    With ``native_seed`` and the native backend (:func:`prep_backend`),
    the whole pass runs in the native library (OpenMP over steps,
    counting sorts; rejection behind ``key_filter``'s filter when given):
    the JAX package's mt19937_64 stream for that seed, which also depends
    on the C++ standard library's ``std::uniform_int_distribution``.
    Otherwise ``rng`` draws the numpy (PCG64) stream of the JAX package's
    ``prep_epoch`` under ``CYMF_TPU_PREP=numpy``.  Each stream is
    deterministic in its seed.

    ``sides=False`` (the sharded engines, which sort each shard's slice)
    skips the numpy path's j-side sort and returns None in its place; the
    native pass computes it whatever the flag, and draws the same stream.

    Returns ``(j2, mask uint8, sj, rowsj, winj)``."""
    S, B = u2.shape
    if native_seed is not None and prep_backend() == "native":
        u2 = np.ascontiguousarray(u2, np.int32)
        # slots=1: the logical H layout's target row IS the item id
        if key_filter is not None:
            fkeys, filt, indptr, log2_bits = key_filter
            j2, mask, sj, rowsj, winj = native.bpr_prep_epoch_v3(
                u2, fkeys, indptr, filt, S, B, num_users, num_items, 1, rh,
                wrows_h, tile, native_seed, log2_bits)
        else:
            j2, mask, sj, rowsj, winj = native.bpr_prep_epoch_v2(
                u2, np.ascontiguousarray(pos_keys, np.int64), S, B, num_users, num_items, 1, rh, wrows_h,
                tile, native_seed)
        return (j2.reshape(S, B), mask.reshape(S, B).astype(np.uint8),
                sj.reshape(S, B), rowsj.reshape(S, B // 128, 128),
                winj.reshape(S, 2, rh // wrows_h))
    j2 = rng.integers(0, num_items, (S, B)).astype(np.int32)
    mask = _reject_mask(u2, j2, pos_keys, num_users, num_items)
    if not sides:
        return j2, mask, None, None, None
    sj, rowsj, winj = _sorted_side(j2, rh, wrows_h, tile)
    return j2, mask, sj, rowsj, winj


# ---------------------------------------------------------------------------
# the sharded engines' host prep (`cymf_tpu/ops/packed_epoch.py:717-827`)
# ---------------------------------------------------------------------------

def _shards(n: int, shard):
    """The shards a sharded prep builds: all ``n``, or ``shard`` alone."""
    return range(n) if shard is None else [int(shard)]


def shard_slices(u2, K: int, rw: int, n: int, tile: int = TILE,
                 slots: int | None = None):
    """Per-step contiguous slice boundaries of the u-sorted sample stream
    for ``n`` equal W row shards (the sharded packed engine's partition).
    ``slots`` overrides the lane-packing slot count (the sharded wide
    engine passes 1: at K >= 128 the target row IS the user id).

    Each step's stream is ascending in u, and shard ``p`` owns packed rows
    ``[p*rw/n, (p+1)*rw/n)``, so shard p's samples are exactly one
    contiguous slice per step, found by binary search.  Global padding
    sentinels (``PAD_USER``) sort last and land in the final shard.

    Returns ``(starts int64[S, n], counts int64[S, n], Bd)``: ``Bd`` (a
    ``tile`` multiple) is the per-shard batch, the longest slice over
    every (step, shard).  On degree-balanced row ranges Bd ~= B/n."""
    S, B = u2.shape
    s = pk.num_slots(K) if slots is None else int(slots)
    if rw % n:
        raise ValueError("rw must be a multiple of the device count")
    rw_l = rw // n
    bounds = np.arange(1, n, dtype=np.int64) * rw_l * s
    splits = np.empty((S, n - 1), np.int64)
    u64 = np.asarray(u2, np.int64)
    for t in range(S):
        splits[t] = np.searchsorted(u64[t], bounds)
    starts = np.concatenate([np.zeros((S, 1), np.int64), splits], axis=1)
    ends = np.concatenate([splits, np.full((S, 1), B, np.int64)], axis=1)
    counts = ends - starts
    Bd = max(int(counts.max()), 1)
    # small batches see 2x skew from ordinary randomness; only flag
    # shard-degenerate streams at sizes where 2x means real imbalance
    if n > 1 and B // n >= 1024 and Bd > 2 * B // n:
        import warnings
        warnings.warn(
            f"sharded packed engine: one shard owns {Bd} of {B} samples "
            f"in some step (balanced would be ~{B // n}); every shard is "
            "padded to that length, multiplying per-step compute/memory. "
            "A degree-skewed user->shard distribution is the usual cause "
            "— consider the sharded batch engine (packed='off') instead.",
            stacklevel=2)
    return starts, counts, -(-Bd // tile) * tile


def prep_shard_static(u2, i2, K: int, rw: int, rh: int, wrows_w: int,
                      wrows_h: int, n: int, tile: int = TILE, shard=None):
    """Once per fit (sharded packed engine): slice the static u/i streams
    into ``n`` shard-contiguous pieces, localize user ids to shard row
    offsets, and build the per-shard W windows and i-side sorted streams.

    Padding samples get the local W-row sentinel ``rw_local * s`` (its
    packed row ``rw_local`` is outside every accumulation window; the
    gather clamps), item index 0 (they accumulate exactly-zero Q rows),
    and mask 0 via :func:`prep_shard_epoch`.

    Returns ``(u_loc, i_loc, winw, si, rowsi, wini, starts, counts, Bd)``
    with a leading shard axis on every stream array, the JAX package's
    arrays bit for bit; ``shard=p`` builds shard ``p``'s alone (a leading
    axis of 1: a rank's own streams)."""
    S, B = u2.shape
    s = pk.num_slots(K)
    starts, counts, Bd = shard_slices(u2, K, rw, n, tile)
    rw_l = rw // n
    sent = rw_l * s
    ps = _shards(n, shard)
    m = len(ps)
    u_loc = np.full((m, S, Bd), sent, np.int32)
    i_loc = np.zeros((m, S, Bd), np.int32)
    winw = np.empty((m, S, 2, rw_l // wrows_w), np.int32)
    si = np.empty((m, S, Bd), np.int32)
    rowsi = np.empty((m, S, Bd // 128, 128), np.int32)
    wini = np.empty((m, S, 2, rh // wrows_h), np.int32)
    u64 = np.asarray(u2, np.int64)
    for q, p in enumerate(ps):
        off = np.int64(p) * rw_l * s
        for t in range(S):
            a, c = int(starts[t, p]), int(counts[t, p])
            u_loc[q, t, :c] = np.minimum(u64[t, a:a + c] - off, sent)
            i_loc[q, t, :c] = i2[t, a:a + c]
            pu = u_loc[q, t].astype(np.int64) // s
            winw[q, t, 0], winw[q, t, 1] = window_ranges(
                pu, rw_l, wrows_w, tile, align=128)
        si[q], rowsi[q], wini[q] = _sorted_side(i_loc[q], rh, wrows_h, tile)
    return u_loc, i_loc, winw, si, rowsi, wini, starts, counts, Bd


def prep_shard_epoch(j2, mask, starts, counts, Bd: int, rh: int,
                     wrows_h: int, n: int, tile: int = TILE, shard=None):
    """Once per epoch (sharded engines): slice the globally drawn negative
    stream (the 1-device stream: draws happen before sharding, so fits are
    mesh-size-invariant up to float summation order) and rebuild the
    j-side sorted streams per shard.  Returns ``(j_loc, mf, sj, rowsj,
    winj)``, the JAX package's arrays bit for bit; ``shard=p``: shard
    ``p``'s alone, as :func:`prep_shard_static`."""
    S, B = j2.shape
    ps = _shards(n, shard)
    m = len(ps)
    j_loc = np.zeros((m, S, Bd), np.int32)
    mf = np.zeros((m, S, Bd), np.uint8)
    sj = np.empty((m, S, Bd), np.int32)
    rowsj = np.empty((m, S, Bd // 128, 128), np.int32)
    winj = np.empty((m, S, 2, rh // wrows_h), np.int32)
    for q, p in enumerate(ps):
        for t in range(S):
            a, c = int(starts[t, p]), int(counts[t, p])
            j_loc[q, t, :c] = j2[t, a:a + c]
            mf[q, t, :c] = mask[t, a:a + c]
        sj[q], rowsj[q], winj[q] = _sorted_side(j_loc[q], rh, wrows_h, tile)
    return j_loc, mf, sj, rowsj, winj
