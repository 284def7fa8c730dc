"""Packed-table fused BPR epoch, pipeline v4 — the single-chip fast path.

Port of `cymf_tpu/ops/packed_epoch.py` for one device.  Each step of an
epoch (a Python loop in place of ``lax.scan``):

1. gathers the packed user rows ``Wp[u // s]`` and the logical item rows
   ``Hp[i]``, ``Hp[j]`` (plain ``index_select``) and decorates the user rows
   with the mask-scaled slot one-hot;
2. runs the fused sample kernel (:func:`~.fused_sample.bpr_sample_phase`);
3. accumulates the W side over the user-sorted stream
   (:func:`~.sorted_accum.sorted_accum`);
4. accumulates both H sides into one buffer by the host-computed item
   sort permutations (:func:`~.sorted_accum.sorted_accum_dual`);
5. runs one packed optimizer pass per table.

Weight decay is rebuilt per row as ``wd * n_r * T_r`` from the live-sample
counts of the count channel, and a row is touched iff a live sample hit
it: the count-based mask of the JAX package, never a value-based one.

Host prep is the numpy branch of the JAX package, verbatim
(:func:`prep_static` for the v4 streams, :func:`prep_epoch` with the same
``default_rng((seed, epoch))`` draws), so both packages train on the same
streams.  The data-gated v5/v6 pipelines, the v7/v8 variants and the
device-side prep are not ported yet; the native C++ prep is not either.
"""

from __future__ import annotations

import numpy as np
import torch

from . import packed as pk
from .fused_sample import bpr_sample_phase, decorate
from .sorted_accum import sorted_accum, sorted_accum_dual, window_ranges

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


@torch.no_grad()
def packed_bpr_epoch(Wp, Hp, ow, oh, u_steps, i_steps, si_steps,
                     rowsi_steps, wini, j_steps, mask_steps, sj_steps,
                     rowsj_steps, winj, winw, n_valid: int, *,
                     opt_name: str, lr: float, weight_decay: float, K: int,
                     rw: int, rh: int, wrows_w: int = 256,
                     wrows_h: int = 256) -> torch.Tensor:
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
    """
    opt = make_packed_optimizer(opt_name, lr)
    wd = float(weight_decay)
    s = pk.num_slots(K)
    cb = pk.count_base(K)
    lane = torch.arange(pk.LANES, device=Wp.device)
    payb = lane < K
    payf = payb.to(Wp.dtype)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for t in range(u_steps.shape[0]):
        u, mf = u_steps[t], mask_steps[t].to(torch.float32)
        phys_u, slot_u = u // s, u % s
        # clamp only the gather index: padding sentinels stay >= rw so the
        # accumulation drops them, and the kernel mask-zeroes their values
        Du = decorate(Wp.index_select(0, phys_u.clamp(max=rw - 1)), slot_u,
                      mf, K)
        SW, Q, loss_t = bpr_sample_phase(
            Du, Hp.index_select(0, i_steps[t]),
            Hp.index_select(0, j_steps[t]), K=K, wd=wd)
        loss += loss_t

        Aw = sorted_accum(phys_u, SW, winw[t, 0], winw[t, 1], r_pad=rw,
                          wrows=wrows_w)
        gw, nw = pk.split_counts(Aw, K)
        nwE = pk.expand_counts(nw, K)
        gbw = _pad_lanes(-gw + wd * nwE * Wp[:, :cb])
        mw = _pad_lanes(nwE > 0)
        opt.update(Wp, ow, gbw, mw)

        # logical H: one dual-stream accumulation yields Aj - Ai on the
        # payload lanes with the live counts summed at lane K
        D = sorted_accum_dual(
            rowsi_steps[t], Q.index_select(0, si_steps[t]), wini[t, 0],
            wini[t, 1], rowsj_steps[t], Q.index_select(0, sj_steps[t]),
            winj[t, 0], winj[t, 1], r_pad=rh, neg_lanes=K, wrows=wrows_h)
        nh = D[:, K:K + 1]
        gbh = (D + wd * nh * Hp) * payf
        mh = (nh > 0) & payb
        opt.update(Hp, oh, gbh, mh)
    return loss / max(int(n_valid), 1)


# ---------------------------------------------------------------------------
# host-side preparation (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _sorted_side(vals2, r_pad, wrows, tile):
    """Per-step sort permutation + folded sorted rows + windows for one
    H side (``vals2`` = item ids, int [S, B]).  The H table is stored in
    LOGICAL layout, so the target row IS the item id."""
    S, B = vals2.shape
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



def prep_static(u2, i2, K: int, rw: int, rh: int, wrows_w: int,
                wrows_h: int, tile: int = TILE):
    """Once per fit, the v4 part of the JAX package's ``prep_static``:
    the W-side windows over the sorted packed rows, and the full i-side
    prep (batch composition is fixed across epochs, `bpr.pyx:104`).

    Returns ``(winw, si, rowsi, wini)``."""
    S, B = u2.shape
    s = pk.num_slots(K)
    nb = rw // wrows_w
    winw = np.empty((S, 2, nb), np.int32)
    for t in range(S):
        pu = np.minimum(u2[t].astype(np.int64) // s, np.iinfo(np.int32).max)
        winw[t, 0], winw[t, 1] = window_ranges(pu, rw, wrows_w, tile,
                                               align=128)
    si, rowsi, wini = _sorted_side(i2, rh, wrows_h, tile)
    return winw, si, rowsi, wini


def prep_epoch(rng: np.random.Generator, u2: np.ndarray, i2: np.ndarray,
               pos_keys: np.ndarray, num_users: int, num_items: int, K: int,
               rh: int, wrows_h: int, tile: int = TILE):
    """Once per epoch: negative draws, rejection+padding mask, and the
    j-side sort permutation/rows/windows.  Mirrors `bpr.pyx:165-167`: one
    uniform draw per interaction, collisions with known positives masked
    out.  The numpy (PCG64) stream of the JAX package's ``prep_epoch``
    under ``CYMF_TPU_PREP=numpy``.

    Returns ``(j2, mask uint8, sj, rowsj, winj)``."""
    S, B = u2.shape
    j2 = rng.integers(0, num_items, (S, B)).astype(np.int32)
    u64 = u2.astype(np.int64)
    in_data = u64 < num_users
    keys = u64 * num_items + j2
    idx = np.searchsorted(pos_keys, keys)
    idx = np.minimum(idx, max(len(pos_keys) - 1, 0))
    collide = (pos_keys[idx] == keys) if len(pos_keys) else \
        np.zeros_like(keys, bool)
    mask = (in_data & ~collide).astype(np.uint8)
    sj, rowsj, winj = _sorted_side(j2, rh, wrows_h, tile)
    return j2, mask, sj, rowsj, winj
