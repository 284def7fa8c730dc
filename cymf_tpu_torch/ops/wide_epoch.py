"""Wide-row fused BPR epoch: the fast path for K >= 128.

Port of `cymf_tpu/ops/wide_epoch.py` for one device.  At K >= 128 rows
already fill whole 128-lane granules, so nothing is packed: the tables are
``(rows, Kp)`` with ``Kp`` K padded to a granule multiple.  Each step of an
epoch (a Python loop in place of ``lax.scan``) gathers the user and item
rows, computes the per-sample math as plain torch elementwise operations
(no TPU kernel computes it), and accumulates both sides with the count-lane
form of the sorted accumulations
(:func:`~.sorted_accum.sorted_accum` and
:func:`~.sorted_accum.sorted_accum_dual` with ``count_lanes=True``): the
gradient streams carry payload lanes only, dead samples are routed to the
sentinel rows ``rw`` / ``rh``, and each row's live count comes back on lane
``Kp`` of the output, for the weight-decay reconstruction ``wd * n_r *
T_r`` and the count-based touched-row mask of the packed engine.

Host prep is the JAX package's numpy prep: :func:`prep_static_wide` once
per fit, then per epoch ``packed_epoch.prep_epoch`` and
:func:`wide_sorted_masks`; the sharded engine's
(``parallel/shard_step.py::sharded_wide_bpr_epoch``) are
:func:`prep_shard_static_wide` and ``packed_epoch.prep_shard_epoch`` with
:func:`wide_shard_masks`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .packed_epoch import (_shards, _sorted_side, make_packed_optimizer,
                           shard_slices)
from .sorted_accum import sorted_accum, sorted_accum_dual, window_ranges

TILE = 1024
LANES = 128


def kp_width(K: int) -> int:
    """Payload lanes of the wide layout: K padded to a granule multiple."""
    return -(-int(K) // LANES) * LANES


def wide_rows(n: int, multiple: int = 512) -> int:
    return -(-int(n) // multiple) * multiple


def pack_wide(table, K: int, multiple: int = 512) -> np.ndarray:
    """(N, K) -> (R, Kp) float32 with zero padding."""
    table = np.asarray(table, np.float32)
    N = table.shape[0]
    out = np.zeros((wide_rows(N, multiple), kp_width(K)), np.float32)
    out[:N, :K] = table[:, :K]
    return out


def wide_sorted_masks(mask, si, sj):
    """Once per epoch (host): the per-stream live masks in sorted order,
    folded lane-major, ``(S, B//128, 128)`` uint8 each.  The epoch routes
    masked samples' target rows to the sentinel so the accumulations count
    live samples by their matches."""
    S, B = mask.shape
    mi = np.take_along_axis(mask, si, axis=1)
    mj = np.take_along_axis(mask, sj, axis=1)
    return (mi.reshape(S, B // LANES, LANES),
            mj.reshape(S, B // LANES, LANES))


def prep_static_wide(u2, i2, rw: int, rh: int, wrows: int,
                     tile: int = TILE):
    """Once per fit: folded sorted user rows + W windows (u pre-sorted),
    and the full i-side prep.  Returns ``(rowsu, winw, si, rowsi, wini)``."""
    S, B = u2.shape
    rowsu = np.empty((S, B // LANES, LANES), np.int32)
    winw = np.empty((S, 2, rw // wrows), np.int32)
    for t in range(S):
        rowsu[t] = u2[t].reshape(B // LANES, LANES)
        winw[t, 0], winw[t, 1] = window_ranges(u2[t], rw, wrows, tile,
                                               align=128)
    si, rowsi, wini = _sorted_side(i2, rh, wrows, tile)
    return rowsu, winw, si, rowsi, wini


def prep_shard_static_wide(u2, i2, rw: int, rh: int, wrows: int, n: int,
                           tile: int = TILE, shard=None):
    """Once per fit (sharded wide engine): slice the u-sorted static streams
    into ``n`` shard-contiguous pieces (slots = 1: the target row IS the
    id), localize user ids to shard row offsets, and build the per-shard W
    windows, folded rows and i-side sorted streams.  Shard ``p`` owns rows
    ``[p*rw/n, (p+1)*rw/n)`` of the wide W table, as in
    ``packed_epoch.prep_shard_static``.

    Returns ``(u_loc, rowsu, winw, i_loc, si, rowsi, wini, starts, counts,
    Bd)`` with a leading shard axis on every stream array, the JAX
    package's arrays bit for bit; ``shard=p``: shard ``p``'s alone (a
    leading axis of 1)."""
    S, B = u2.shape
    starts, counts, Bd = shard_slices(u2, 0, rw, n, tile, slots=1)
    rw_l = rw // n
    sent = rw_l  # local sentinel: outside every window, the gather clamps
    ps = _shards(n, shard)
    m = len(ps)
    u_loc = np.full((m, S, Bd), sent, np.int32)
    i_loc = np.zeros((m, S, Bd), np.int32)
    rowsu = np.empty((m, S, Bd // LANES, LANES), np.int32)
    winw = np.empty((m, S, 2, rw_l // wrows), np.int32)
    si = np.empty((m, S, Bd), np.int32)
    rowsi = np.empty((m, S, Bd // LANES, LANES), np.int32)
    wini = np.empty((m, S, 2, rh // wrows), np.int32)
    u64 = np.asarray(u2, np.int64)
    for q, p in enumerate(ps):
        off = np.int64(p) * rw_l
        for t in range(S):
            a, c = int(starts[t, p]), int(counts[t, p])
            u_loc[q, t, :c] = np.minimum(u64[t, a:a + c] - off, sent)
            i_loc[q, t, :c] = i2[t, a:a + c]
            rowsu[q, t] = u_loc[q, t].reshape(Bd // LANES, LANES)
            winw[q, t, 0], winw[q, t, 1] = window_ranges(
                u_loc[q, t], rw_l, wrows, tile, align=128)
        si[q], rowsi[q], wini[q] = _sorted_side(i_loc[q], rh, wrows, tile)
    return u_loc, rowsu, winw, i_loc, si, rowsi, wini, starts, counts, Bd


def wide_shard_masks(mf, si, sj):
    """Per epoch (sharded wide engine): :func:`wide_sorted_masks` applied
    shard by shard to the sliced masks and the per-shard sort
    permutations.  Returns ``(mi, mj)`` uint8 ``(n, S, Bd//128, 128)``
    each."""
    n, S, Bd = mf.shape
    mi = np.empty((n, S, Bd // LANES, LANES), np.uint8)
    mj = np.empty((n, S, Bd // LANES, LANES), np.uint8)
    for p in range(n):
        mi[p], mj[p] = wide_sorted_masks(mf[p], si[p], sj[p])
    return mi, mj


def wide_sample_phase(W, H, u, i, j, mf, *, rw: int, wd: float):
    """A step's per-sample math on gathered wide rows: ``(SW, Q, loss)``
    with ``SW = sig (h_i - h_j)`` and ``Q = sig w_u`` (``sig =
    sigmoid(-x) * mf``, the mask folded in) and the step's loss sum.  Only
    the gather index is clamped: padding users (``PAD_USER``) read row
    ``rw - 1`` and the mask zeroes their values."""
    wu = W.index_select(0, u.clamp(max=rw - 1))
    hi = H.index_select(0, i)
    hj = H.index_select(0, j)
    diff = hi - hj
    x = torch.sum(wu * diff, dim=1, keepdim=True)
    sigm = torch.sigmoid(-x) * mf[:, None]
    l2 = torch.sum(wu * wu + hi * hi + hj * hj, dim=1)
    loss = torch.sum((-F.logsigmoid(x[:, 0]) + wd * l2) * mf)
    return sigm * diff, sigm * wu, loss


@torch.no_grad()
def wide_bpr_epoch(W, H, ow, oh, u_steps, i_steps, rowsu_steps, winw,
                   si_steps, rowsi_steps, wini, j_steps, mask_steps,
                   sj_steps, rowsj_steps, winj, mi_steps, mj_steps,
                   n_valid: int, *, opt_name: str, lr: float,
                   weight_decay: float, K: int, rw: int, rh: int,
                   wrows: int = 512) -> torch.Tensor:
    """One epoch over S pre-sorted minibatches, K >= 128; returns the mean
    loss (0-d tensor, ``sum / max(n_valid, 1)``).

    ``W`` / ``H`` are ``(rw, Kp)`` / ``(rh, Kp)`` wide tables, updated IN
    PLACE with their optimizer states ``ow`` / ``oh``.  The streams are
    device tensors laid out as the JAX package's (slots = 1: the target
    row is the id):

      u_steps int32[S, B]        users, ascending (padding: PAD_USER)
      i_steps int32[S, B]        positives, aligned with u
      rowsu_steps int32[S, B/128, 128]  folded sorted users
      winw int32[S, 2, rw/wrows]        W-side windows
      si/rowsi/wini              i-side sort permutation, rows, windows
      j_steps int32[S, B]        negatives, aligned with u
      mask_steps uint8[S, B]     1 = live sample
      sj/rowsj/winj              j-side analogues of si/rowsi/wini
      mi_steps/mj_steps uint8[S, B/128, 128]  :func:`wide_sorted_masks`
    """
    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=W.device)
    for t in range(u_steps.shape[0]):
        loss += wide_step(
            W, H, ow, oh, opt, u_steps[t], i_steps[t], rowsu_steps[t],
            winw[t, 0], winw[t, 1], si_steps[t], rowsi_steps[t], wini[t, 0],
            wini[t, 1], j_steps[t], mask_steps[t], sj_steps[t],
            rowsj_steps[t], winj[t, 0], winj[t, 1], mi_steps[t], mj_steps[t],
            weight_decay=weight_decay, K=K, rw=rw, rh=rh, wrows=wrows)
    return loss / max(int(n_valid), 1)


def wide_step(W, H, ow, oh, opt, u, i, rowsu, ww_starts, ww_counts, si,
              rowsi, wi_starts, wi_counts, j, mask, sj, rowsj, wj_starts,
              wj_counts, mi, mj, *, weight_decay: float, K: int, rw: int,
              rh: int, wrows: int, reduce_h=None) -> torch.Tensor:
    """One wide step (the streams of :func:`wide_bpr_epoch` at one step);
    updates ``W``, ``H`` and their optimizer states IN PLACE and returns the
    step's loss sum.  The sharded epoch runs it on a rank's row shard of
    ``W`` (``rw`` its rows) with ``reduce_h`` its all-reduce of the H-side
    sums ``D`` between their accumulation and the H pass."""
    wd = float(weight_decay)
    Kp = W.shape[1]
    payb = (torch.arange(Kp, device=W.device) < K)[None, :]
    payf = payb.to(W.dtype)
    # dead and padding samples -> sentinel rows (never match a window)
    rowsu_m = torch.where(mask.reshape(rowsu.shape) > 0, rowsu, rw)
    rowsi_m = torch.where(mi > 0, rowsi, rh)
    rowsj_m = torch.where(mj > 0, rowsj, rh)
    SW, Q, loss = wide_sample_phase(W, H, u, i, j, mask.to(torch.float32),
                                    rw=rw, wd=wd)

    Aw = sorted_accum(rowsu_m, SW, ww_starts, ww_counts, r_pad=rw,
                      wrows=wrows, count_lanes=True)
    nw = Aw[:, Kp:Kp + 1]
    opt.update(W, ow, (-Aw[:, :Kp] + wd * nw * W) * payf, (nw > 0) & payb)
    del Aw, SW

    D = sorted_accum_dual(
        rowsi_m, Q.index_select(0, si), wi_starts, wi_counts, rowsj_m,
        Q.index_select(0, sj), wj_starts, wj_counts, r_pad=rh, neg_lanes=Kp,
        wrows=wrows, count_lanes=True)
    if reduce_h is not None:
        reduce_h(D)
    nh = D[:, Kp:Kp + 1]
    opt.update(H, oh, (D[:, :Kp] + wd * nh * H) * payf, (nh > 0) & payb)
    return loss
