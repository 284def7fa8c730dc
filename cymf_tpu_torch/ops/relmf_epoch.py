"""Packed fused RelMF engine, with host or device stream prep.

Port of `cymf_tpu/ops/relmf_epoch.py` for one device.  The per-sample
math maps onto the GloVe sample phase (:func:`~.glove_epoch.
glove_sample_phase`): with the clipped relevance weight
``theta = r / max(p_i, M)`` on the context decoration's "-log(count)" lane
and the weight lane set to 1, the phase's ``diff = w.h - theta`` is the
reference's shared gradient factor (`cymf/model.pyx:130-139`, no factor
2) and its outputs are the lane-placed W gradient and the compact H
gradient.  What differs from GloVe is in the step:

* loss: ``theta (1-s)^2 + (1-theta) s^2 = diff^2 + theta (1-theta)``, so
  the phase's ``0.5 diff^2`` sum is doubled and ``theta (1-theta)`` plus
  the reference's ``wd * l2`` term (from the count channels against the
  step-start tables) are added;
* weight decay is ADDED into both gradients (the `model.pyx` sign quirk;
  BPR subtracts).

Every epoch draws its whole cell stream.  Two sources feed the one step
body, :func:`relmf_step`:

* host prep (:func:`prep_relmf_epoch`): the JAX package's two host
  streams, the native library's (mt19937_64, by default) and its numpy
  branch verbatim (``CYMF_TPU_PREP=numpy``), so both packages train on
  identical streams; ``1 / max(p, M)`` comes from a ``(rh, 1)`` column;
* device prep (:func:`packed_relmf_epoch_device`): each step draws its
  cells from one explicit ``torch.Generator`` on the tables' device,
  labels them with the pair hash set, sorts them by user and builds both
  sides' windows there; ``1 / max(p, M)`` rides on lane ``K`` of the item
  table.  The JAX package draws with threefry, which torch does not
  reproduce: the two device streams differ, the step body is the same.

The JAX package dispatches device-prep epochs in scans of at most 2048
steps (``CYMF_TPU_RELMF_CHUNK_STEPS``), a workaround for its remote
relay; the port runs one loop per epoch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import packed as pk
from .fused_sample import decorate
from .glove_epoch import decorate_x, glove_sample_phase
from .hashset import PairHashSet, hashset_contains
from .. import native
from .packed_epoch import (TILE, _packed_windows, _pad_lanes, _reject_mask,
                           _sorted_side, make_packed_optimizer, prep_backend)
from .sorted_accum import sorted_accum

LANES = 128


def supports_packed_relmf(K: int) -> bool:
    """The payload must lane-pack and the context decoration needs lanes
    ``K`` and ``K + 1`` free."""
    return pk.packable(K) and K + 2 <= LANES


def prep_relmf_epoch(seed, epoch, S: int, B: int, num_users: int,
                     num_items: int, K: int, rw: int, rh: int,
                     wrows_w: int, wrows_h: int, pos_keys: np.ndarray,
                     key_filter=None, tile: int = TILE):
    """Once per epoch, on the host: draw ``S*B`` uniform (u, i) cells (the
    reference samples positives and negatives, `relmf.pyx:143-148`),
    label them by membership in the sorted positive keys, sort each step
    by user, and build both accumulation sides.

    With ``key_filter`` (:func:`~.packed_epoch.make_reject_filter`) and
    the native backend, the whole pass runs in the native library (OpenMP
    over steps, counting sorts by the user's packed row, then by item):
    the JAX package's mt19937_64 stream seeded ``seed * 1_000_003 + epoch
    + 0x5e1f``.  Otherwise the numpy branch of the JAX package (PCG64,
    ``default_rng((seed, epoch, 7))``), verbatim.

    Returns ``(u2, i2, lab, winw, si, rowsi, wini)``: every stream in
    u-sorted per-step order (the native stream: sorted by packed row),
    ``lab`` uint8."""
    if key_filter is not None and prep_backend() == "native":
        keys, filt, indptr, log2_bits = key_filter
        nw, nh = rw // wrows_w, rh // wrows_h
        u2, i2, lab, winw, si, rowsi, wini = native.relmf_prep_epoch(
            keys, indptr, filt, S, B, num_users, num_items,
            pk.num_slots(K), rw, rh, wrows_w, wrows_h, tile,
            int(seed) * 1_000_003 + int(epoch) + 0x5e1f, log2_bits)
        return (u2.reshape(S, B), i2.reshape(S, B), lab.reshape(S, B),
                winw.reshape(S, 2, nw), si.reshape(S, B),
                rowsi.reshape(S, B // 128, 128), wini.reshape(S, 2, nh))
    rng = np.random.default_rng((int(seed), int(epoch), 7))
    r = rng.integers(0, np.int64(num_users) * num_items, (S, B),
                     dtype=np.int64)
    u2 = (r // num_items).astype(np.int32)
    i2 = (r % num_items).astype(np.int32)
    order = np.argsort(u2, axis=1, kind="stable")
    u2 = np.take_along_axis(u2, order, axis=1)
    i2 = np.take_along_axis(i2, order, axis=1)
    # label = membership in the positives: the complement of BPR's
    # rejection mask (every cell is in-data here)
    lab = 1 - _reject_mask(u2, i2, pos_keys, num_users, num_items,
                           key_filter=key_filter)
    winw = _packed_windows(u2, pk.num_slots(K), rw, wrows_w, tile)
    si, rowsi, wini = _sorted_side(i2, rh, wrows_h, tile)
    return u2, i2, lab, winw, si, rowsi, wini


def window_ranges_device(rows_sorted: torch.Tensor, r_pad: int, wrows: int,
                         tile: int = TILE):
    """:func:`~.sorted_accum.window_ranges` (``align=128``) on the device,
    bit-identical to it: per window of ``wrows`` rows, the int32
    ``(starts, counts)`` sample ranges over the ascending (B,) stream
    ``rows_sorted``."""
    B = rows_sorted.shape[0]
    nw = r_pad // wrows
    bounds = torch.arange(nw + 1, dtype=rows_sorted.dtype,
                          device=rows_sorted.device) * wrows
    edges = torch.searchsorted(rows_sorted, bounds).to(torch.int64)
    Bp = -(-max(B, 1) // tile) * tile
    starts = (edges[:-1] // 128) * 128
    counts = edges[1:] - starts
    nch = -(-counts // tile)
    over = starts + nch * tile > Bp
    need = torch.maximum(nch, -(-(Bp - edges[:-1]) // tile))
    starts = torch.where(over, Bp - need * tile, starts)
    counts = edges[1:] - starts
    return starts.to(torch.int32), counts.to(torch.int32)


def _sorted_side_device(vals: torch.Tensor, r_pad: int, wrows: int,
                        tile: int = TILE):
    """:func:`~.packed_epoch._sorted_side` on the device for one (B,)
    stream: ``(perm, sorted rows, starts, counts)``."""
    srt, perm = torch.sort(vals, stable=True)
    starts, counts = window_ranges_device(srt, r_pad, wrows, tile)
    return perm, srt, starts, counts


def relmf_step(Wp, Hp, ow, oh, opt, u, i, lab, si, rowsi, wi_starts,
               wi_counts, ww_starts, ww_counts, invp, *, weight_decay: float,
               K: int, rw: int, rh: int, wrows_w: int, wrows_h: int
               ) -> torch.Tensor:
    """One synchronous packed RelMF step over u-sorted cells; updates
    ``Wp``, ``Hp`` and their optimizer states IN PLACE and returns the
    step's loss sum (0-d tensor).

    ``u``/``i`` are int32 (B,) user and item ids (ascending in u), ``lab``
    their float32 0/1 labels, ``si``/``rowsi``/``wi_*`` the item side's
    sort permutation, sorted rows and windows, ``ww_*`` the user side's
    windows over ``u // s``.  ``invp`` is the ``(rh, 1)`` column of
    ``1 / max(p_i, M)``, or None when it rides on lane ``K`` of ``Hp``
    (device prep).  Both prep paths run this body."""
    wd = float(weight_decay)
    s = pk.num_slots(K)
    cb = pk.count_base(K)
    lane = torch.arange(LANES, device=Wp.device)
    payb = lane < K
    payf = payb.to(Wp.dtype)
    ones = torch.ones(u.shape[0], dtype=torch.float32, device=Wp.device)
    phys, slot = u // s, u % s
    Du = decorate(Wp.index_select(0, phys.clamp(max=rw - 1)), slot, ones, K)
    Dxg = Hp.index_select(0, i)
    invp_i = Dxg[:, K] if invp is None else invp[:, 0].index_select(0, i)
    th = lab * invp_i
    Dx = decorate_x(Dxg, ones, th, K)
    SW, Q, lossp = glove_sample_phase(Du, Dx, Kp=K)

    Aw = sorted_accum(phys, SW, ww_starts, ww_counts, r_pad=rw,
                      wrows=wrows_w)
    gw, nw = pk.split_counts(Aw, K)
    nwE = pk.expand_counts(nw, K)
    # the loss's l2 term reads the step-start tables
    l2w = torch.sum(nwE * torch.square(Wp[:, :cb]))
    # decay ADDED into the gradient (model.pyx:130-139 sign quirk)
    gbw = _pad_lanes(gw + wd * nwE * Wp[:, :cb])
    mw = _pad_lanes(nwE > 0)
    opt.update(Wp, ow, gbw, mw)

    D = sorted_accum(rowsi, Q.index_select(0, si), wi_starts, wi_counts,
                     r_pad=rh, wrows=wrows_h)
    nh = D[:, K:K + 1]
    l2h = torch.sum(nh * torch.square(Hp * payf))
    # payload-masked: lane K of Hp (invp under device prep) never moves
    gbh = (D + wd * nh * Hp) * payf
    mh = (nh > 0) & payb
    opt.update(Hp, oh, gbh, mh)

    # loss = sum diff^2 (the phase's 0.5 f diff^2 with f = 1, doubled)
    #      + sum theta (1 - theta) + wd * sum l2   (model.pyx:117)
    return (2.0 * lossp + torch.sum(th * (1.0 - th))
            + wd * (l2w + l2h))


@torch.no_grad()
def packed_relmf_epoch(Wp, Hp, ow, oh, u_steps, i_steps, lab_steps,
                       si_steps, rowsi_steps, wini, winw, invp, n_valid, *,
                       opt_name: str, lr: float, weight_decay: float, K: int,
                       rw: int, rh: int, wrows_w: int = 256,
                       wrows_h: int = 256) -> torch.Tensor:
    """One epoch over S u-sorted minibatches from :func:`prep_relmf_epoch`
    (device tensors); returns the mean loss (0-d tensor,
    ``sum / max(n_valid, 1)``; ``n_valid`` is a float, since ML-20M's
    3.7e9 cells overflow int32).  ``Wp`` is the packed user table, ``Hp``
    the logical item table, ``invp`` the ``(rh, 1)`` column of
    ``1 / max(p_i, M)``; tables and optimizer states are updated IN
    PLACE.  Update semantics match the JAX package's synchronous
    per-batch step."""
    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for t in range(u_steps.shape[0]):
        loss += relmf_step(
            Wp, Hp, ow, oh, opt, u_steps[t], i_steps[t],
            lab_steps[t].to(torch.float32), si_steps[t], rowsi_steps[t],
            wini[t, 0], wini[t, 1], winw[t, 0], winw[t, 1], invp,
            weight_decay=weight_decay, K=K, rw=rw, rh=rh, wrows_w=wrows_w,
            wrows_h=wrows_h)
    return loss / max(float(n_valid), 1.0)


def draw_cells(gen: torch.Generator, B: int, num_users: int,
               num_items: int, hs: PairHashSet):
    """One step's cells on ``gen``'s device: ``B`` users and ``B`` items
    drawn independently and uniformly (the same distribution over cells
    as the reference's flat draw) and their labels, membership in the
    pair hash set ``hs``.  Returns int32 ``u``, ``i`` and bool ``lab``,
    unsorted."""
    dev = hs.table1.device
    u = torch.randint(0, num_users, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    i = torch.randint(0, num_items, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    return u, i, hashset_contains(hs, u, i)


def device_step(Wp, Hp, ow, oh, opt, u, i, lab, *, weight_decay: float,
                K: int, rw: int, rh: int, wrows_w: int, wrows_h: int
                ) -> torch.Tensor:
    """Device prep of one step's drawn cells, then :func:`relmf_step`:
    sort by user with ``i * 2 + lab`` riding along, the user side's
    windows over ``u // s``, the item side's sort and windows, and
    ``1 / max(p, M)`` read from lane ``K`` of ``Hp``."""
    val = i * 2 + lab.to(torch.int32)
    su, perm = torch.sort(u, stable=True)
    sval = val.index_select(0, perm)
    i_s = sval // 2
    lab_f = (sval & 1).to(torch.float32)
    ws, wc = window_ranges_device(su // pk.num_slots(K), rw, wrows_w)
    si, rowsi, is_, ic = _sorted_side_device(i_s, rh, wrows_h)
    return relmf_step(Wp, Hp, ow, oh, opt, su, i_s, lab_f, si, rowsi, is_,
                      ic, ws, wc, None, weight_decay=weight_decay, K=K,
                      rw=rw, rh=rh, wrows_w=wrows_w, wrows_h=wrows_h)


@torch.no_grad()
def packed_relmf_epoch_device(Wp, Hp, ow, oh, hs: PairHashSet, gen, S: int,
                              n_valid, *, B: int, num_users: int,
                              num_items: int, opt_name: str, lr: float,
                              weight_decay: float, K: int, rw: int, rh: int,
                              wrows_w: int = 256, wrows_h: int = 256
                              ) -> torch.Tensor:
    """Packed RelMF epoch with the stream prep on the tables' device: each
    of the ``S`` steps draws ``B`` cells from ``gen``
    (:func:`draw_cells`), labels them against ``hs`` (tensors on the
    device, :func:`~.hashset.to_device`) and runs :func:`device_step`.
    ``Hp`` carries ``1 / max(p_i, M)`` on lane ``K``.  Returns the mean
    loss; updates tables and states IN PLACE."""
    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for _ in range(S):
        u, i, lab = draw_cells(gen, B, num_users, num_items, hs)
        loss += device_step(Wp, Hp, ow, oh, opt, u, i, lab,
                            weight_decay=weight_decay, K=K, rw=rw, rh=rh,
                            wrows_w=wrows_w, wrows_h=wrows_h)
    return loss / max(float(n_valid), 1.0)
