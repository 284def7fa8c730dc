"""Fused BPR step kernels: the sample phase with the W-side accumulation.

Port of `cymf_tpu/ops/fused_step.py`.  Three pipelines of the packed BPR
engine compute a step's W-side gradient sum ``Aw`` (``rw`` packed rows,
payload and count channels as :func:`~.sorted_accum.sorted_accum` gives
them, the step's loss summed on lane :data:`LOSS_LANE`) and the compact
H-side product ``Q`` in one kernel, so the per-sample W stream ``SW``
never reaches device memory:

- v6, :func:`bpr_block_step_v6`: the W rows are read from the table per
  1024-sample chunk's window of :data:`CROWS` rows (rows outside count as
  zeros), and each W block of ``wrows`` rows sums its home chunks
  (:func:`prep_blocks`) into its rows and the :data:`CROWS` rows after
  them, the spill the next block folds in;
- v7, :func:`bpr_range_step_v7`: over a gathered, decorated W stream, each
  window of ``wrows`` rows sums the samples of its host-computed range
  whose rows it holds (correct for any user sparsity);
- v8, :func:`bpr_pool_step_v8`: v7 with the negatives drawn from a per-step
  pool of ``P`` items, ``hj = Hpool[rj]``, and the pool gradient
  ``Apool[rj] += Q`` summed once per sample, by the window that holds its
  W row.

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/bpr_fused.cu``, one template for the three: a sample-balanced fused
reduction (a warp per part of consecutive samples, runs summed in
registers, the runs that parts share joined and the untouched rows
zeroed by a second pass, ``csrc/segment.cuh``, shared with the
single-stream :func:`~.sorted_accum.sorted_accum`), whose partition
:func:`fused_step_twin` writes out in Python.  On a CPU tensor each
wrapper runs its ``_plain`` version, written as the TPU kernel computes:
the same expansion window rule, the lane rotations of :func:`~.fused_sample.
sample_math_plain`, and ``index_add_`` for the sums.  Sums come in another
order than the TPU's bf16 hi+lo one-hot matmuls, which are exact to about
2^-16 relative: results agree to that, not bit for bit.  The TPU's window
DMA, double-buffered slabs, spill buffer and ``VMEM_LIMIT`` have no
counterpart here.  ``CROWS`` stays: it is part of ``supports_v6``, of
``engine_version``'s data gate and of ``prep_static``'s window starts.
"""

from __future__ import annotations


import numpy as np
import torch

from . import _kernels
from . import packed as pk
from . import sorted_accum as sa
from .fused_sample import expand_rows, sample_math_plain

LANES = 128
TILE = 1024
# W rows covering one chunk's expansion: ceil(TILE / s) + 1 <= 257 at
# s >= 4, rounded to a multiple of 8
CROWS = 264
LOSS_LANE = 127
POOL_MAX = 2048


def supports_v6(K: int, rw: int, wrows: int = 512) -> bool:
    """v6 needs >= 4 slots (chunk expansion window), a free lane 127 for
    the loss channel, a table at least one expansion window tall, and
    blocks tall enough that a chunk's spill never crosses more than one
    block boundary (``wrows >= CROWS``)."""
    s = pk.num_slots(K)
    return s >= 4 and s * (K + 1) <= LOSS_LANE and rw >= CROWS \
        and rw % wrows == 0 and wrows >= CROWS


def supports_v7(K: int, rw: int, wrows: int = 512) -> bool:
    """v7 is span-independent; it only needs the free loss lane and a
    block-tileable table."""
    s = pk.num_slots(K)
    return s * (K + 1) <= LOSS_LANE and rw % wrows == 0


def supports_v8(K: int, rw: int, wrows: int = 512, P: int = 0) -> bool:
    """v8: v7's gates plus a lane-aligned pool of at most POOL_MAX rows."""
    return supports_v7(K, rw, wrows) and P >= LANES \
        and P % LANES == 0 and P <= POOL_MAX


def prep_blocks(wstart: np.ndarray, rw: int, wrows: int = 512):
    """Host-side: per-block home chunk ranges.  ``wstart`` is the
    per-chunk expansion window start (`prep_static`), nondecreasing.
    Returns (cs, cn): int32[rw//wrows] start chunk id and chunk count."""
    bid = (np.asarray(wstart, np.int64) // wrows)
    nb = rw // wrows
    edges = np.searchsorted(bid, np.arange(nb + 1)).astype(np.int32)
    return edges[:-1], (edges[1:] - edges[:-1]).astype(np.int32)


def _check_streams(B: int, tile: int, *rows_like) -> None:
    if B % tile:
        raise ValueError("B must be a multiple of tile")
    for t in rows_like:
        if t.numel() != B:
            raise ValueError(f"{t.numel()} per-sample entries for {B} rows")


def _fused_math(Du, Hi, hj, K: int, wd: float):
    """Sample math of v6-v8: SW with the loss on LOSS_LANE, and Q."""
    SW, Q, loss = sample_math_plain(
        Du, Hi, hj, K=K, wd=wd, cmask_hi=pk.count_base(K) + pk.num_slots(K))
    SW[:, LOSS_LANE] += loss[:, 0]
    return SW, Q


def _chunk_home(cs, cn, nchunks: int):
    """Home block of each chunk from the per-block ranges, -1 for none."""
    cs, cn = cs.long(), cn.long().clamp(min=0)
    dev = cs.device
    blk = torch.arange(cs.numel(), device=dev).repeat_interleave(cn)
    pos = torch.arange(blk.numel(), device=dev) \
        - (torch.cumsum(cn, 0) - cn).repeat_interleave(cn)
    g = cs.repeat_interleave(cn) + pos
    home = torch.full((nchunks,), -1, dtype=torch.long, device=dev)
    ok = (g >= 0) & (g < nchunks)
    home[g[ok]] = blk[ok]
    return home


def _block_keep(rows, cs, cn, *, rw: int, wrows: int, tile: int, B: int):
    """Per sample: whether its chunk has a home block (``home``) and
    whether it lands (``keep``): its row lies in that block or the spill
    after it, inside the table."""
    home = _chunk_home(cs, cn, B // tile).repeat_interleave(tile)
    keep = (home >= 0) & (rows >= home * wrows) \
        & (rows < (home + 1) * wrows + CROWS) & (rows < rw)
    return home >= 0, keep


def bpr_block_step_v6_plain(Wp, rowsw, Hi, Dj_dec, wstart, cs, cn, *,
                            K: int, wd: float, rw: int, wrows: int = 512,
                            tile: int = TILE):
    """Plain PyTorch version of :func:`bpr_block_step_v6`."""
    B = Hi.shape[0]
    rows = rowsw.reshape(-1).long()
    start = wstart.long().repeat_interleave(tile)
    Du, hj = expand_rows(Wp, rows, start, CROWS, Dj_dec, K)
    SW, Q = _fused_math(Du, Hi, hj, K, wd)
    homed, keep = _block_keep(rows, cs, cn, rw=rw, wrows=wrows, tile=tile,
                              B=B)
    Aw = torch.zeros((rw, LANES), dtype=SW.dtype, device=SW.device)
    Aw.index_add_(0, rows[keep], SW[keep])
    return Aw, torch.where(homed[:, None], Q, 0.0)


def bpr_block_step_v6(Wp, rowsw, Hi, Dj_dec, wstart, cs, cn, *, K: int,
                      wd: float, rw: int, wrows: int = 512,
                      tile: int = TILE):
    """Fused sample phase + W accumulation over home blocks.

    Args:
      Wp: (rw, 128) packed user table.
      rowsw: int32 ascending per-sample packed rows, ``B`` elements (the
        JAX package's folded ``(B/128, 128)`` layout is a free view).
      Hi: (B, 128) gathered item rows ``Hp[i]`` (u-order).
      Dj_dec: (B, 128) gathered and decorated negative rows (u-order).
      wstart: int32[B/tile] per-chunk expansion window starts
        (``clip(row[g*tile], 0, rw - CROWS)``, host-computed).
      cs, cn: int32[rw//wrows] per-block home chunk ranges
        (:func:`prep_blocks`).

    Returns:
      Aw: (rw, 128) the W-side sums, the loss sum on lane 127.
      Q: (B, 128) the compact H-side product, as v5; zeros for the samples
        of a chunk that no block's range holds (the TPU kernel leaves those
        rows unwritten; :func:`prep_blocks` homes every chunk).

    The kernel sums ``Aw`` in stream order, so two calls give the same
    bits, and asserts that the rows it keeps are non-decreasing (the rows
    are ascending); a failed device-side assert leaves the CUDA context
    unusable.  It needs ``tile`` a multiple of its part of
    :func:`~.sorted_accum.segment_plan` (64 samples).
    """
    B = Hi.shape[0]
    _check_streams(B, tile, rowsw)
    if not supports_v6(K, rw, wrows):
        raise ValueError("v6 gate: need s >= 4, s*(K+1) <= 127, "
                         "rw >= CROWS and rw % wrows == 0")
    if Wp.shape != (rw, LANES) or Hi.shape != (B, LANES) \
            or Dj_dec.shape != Hi.shape:
        raise ValueError("Wp must be (rw, 128), Hi and Dj_dec (B, 128)")
    if Hi.device.type == "cpu":
        return bpr_block_step_v6_plain(Wp, rowsw, Hi, Dj_dec, wstart, cs,
                                       cn, K=K, wd=wd, rw=rw, wrows=wrows,
                                       tile=tile)
    if Hi.device.type != "cuda":
        raise ValueError(f"bpr_block_step_v6 runs on cpu or cuda, not "
                         f"{Hi.device}")
    dev = Hi.device
    for t, name in ((Wp, "Wp"), (Hi, "Hi"), (Dj_dec, "Dj_dec")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    _kernels.require(rowsw, "rowsw", torch.int32, dev)
    for t, name, n in ((wstart, "wstart", B // tile),
                       (cs, "cs", rw // wrows), (cn, "cn", rw // wrows)):
        _kernels.require(t, name, torch.int32, dev, ndim=1)
        if t.numel() != n:
            raise ValueError(f"{name} must hold {n} entries")
    plan = sa.segment_plan(B, rw, LANES)
    if tile % plan["part"]:
        raise ValueError(f"the v6 kernel needs tile a multiple of "
                         f"{plan['part']}")
    Aw = torch.empty((rw, LANES), dtype=torch.float32, device=dev)
    Q = torch.empty_like(Hi)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=dev)
    _kernels.launch("bpr_block_step_v6", dev,
            Wp, rowsw, Hi, Dj_dec, wstart, cs, cn, Aw, Q, scratch,
            plan["scratch_bytes"], B, rw, wrows, tile, int(K),
            pk.num_slots(K), pk.count_base(K), float(wd))
    return Aw, Q


def _window_keep(rows, starts, counts, *, rw: int, wrows: int, tile: int,
                 B: int):
    """Per sample: its row lies in a window of the table and the sample in
    that window's range, whole chunks of ``tile`` as the TPU walks it."""
    inside = (rows >= 0) & (rows < rw)
    w = rows.clamp(0, rw - 1) // wrows
    st = starts.long()[w].clamp(min=0)
    nc = -(-counts.long()[w].clamp(min=0) // tile)
    b = torch.arange(B, device=rows.device)
    return inside & (b >= st) & (b < torch.clamp(st + nc * tile, max=B))


def bpr_range_step_v7_plain(rowsw, Du_dec, Hi, Dj, starts, counts, *,
                            K: int, wd: float, rw: int, wrows: int = 512,
                            tile: int = TILE):
    """Plain PyTorch version of :func:`bpr_range_step_v7`."""
    rows = rowsw.reshape(-1).long()
    SW, Q = _fused_math(Du_dec, Hi, Dj, K, wd)
    keep = _window_keep(rows, starts, counts, rw=rw, wrows=wrows, tile=tile,
                        B=Hi.shape[0])
    Aw = torch.zeros((rw, LANES), dtype=SW.dtype, device=SW.device)
    Aw.index_add_(0, rows[keep], SW[keep])
    return Aw, Q


def _check_range_cuda(dev, rowsw, streams, starts, counts, nw: int):
    for t, name in streams:
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    _kernels.require(rowsw, "rowsw", torch.int32, dev)
    for t, name in ((starts, "starts"), (counts, "counts")):
        _kernels.require(t, name, torch.int32, dev, ndim=1)
        if t.numel() != nw:
            raise ValueError(f"{name} must hold one entry per window")


def bpr_range_step_v7(rowsw, Du_dec, Hi, Dj, starts, counts, *, K: int,
                      wd: float, rw: int, wrows: int = 512,
                      tile: int = TILE):
    """Span-independent fused sample phase + W accumulation.

    Args:
      rowsw: int32 ascending per-sample packed rows, ``B`` elements
        (padding sentinels >= rw).
      Du_dec: (B, 128) gathered and decorated packed user rows (u-order).
      Hi, Dj: (B, 128) gathered item / negative rows (u-order, raw).
      starts/counts: int32[rw//wrows] per-window sample ranges over the
        sorted rows (`window_ranges`), the LAST window's range extended
        over the padding tail (`prep_static`) so that every sample's Q
        row is written.

    Returns ``(Aw, Q)`` as :func:`bpr_block_step_v6`, Q for every sample.

    The kernel sums ``Aw`` in stream order, so two calls give the same
    bits, and asserts that the rows it keeps are non-decreasing (the rows
    are ascending); a failed device-side assert leaves the CUDA context
    unusable.
    """
    B = Hi.shape[0]
    _check_streams(B, tile, rowsw)
    if not supports_v7(K, rw, wrows):
        raise ValueError("v7 gate: need s*(K+1) <= 127 and "
                         "rw % wrows == 0")
    if not (Du_dec.shape == Hi.shape == Dj.shape == (B, LANES)):
        raise ValueError("Du_dec, Hi and Dj must be (B, 128)")
    if Hi.device.type == "cpu":
        return bpr_range_step_v7_plain(rowsw, Du_dec, Hi, Dj, starts,
                                       counts, K=K, wd=wd, rw=rw,
                                       wrows=wrows, tile=tile)
    if Hi.device.type != "cuda":
        raise ValueError(f"bpr_range_step_v7 runs on cpu or cuda, not "
                         f"{Hi.device}")
    dev = Hi.device
    _check_range_cuda(dev, rowsw, ((Du_dec, "Du_dec"), (Hi, "Hi"),
                                   (Dj, "Dj")), starts, counts, rw // wrows)
    Aw = torch.empty((rw, LANES), dtype=torch.float32, device=dev)
    Q = torch.empty_like(Hi)
    nbytes = sa.segment_plan(B, rw, LANES)["scratch_bytes"]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _kernels.launch("bpr_range_step_v7", dev,
            rowsw, Du_dec, Hi, Dj, starts, counts, Aw, Q, scratch, nbytes, B,
            rw, wrows, tile, int(K), pk.num_slots(K), pk.count_base(K),
            float(wd))
    return Aw, Q


def bpr_pool_step_v8_plain(rowsw, rjs, Du_dec, Hi, Hpool, starts, counts, *,
                           K: int, wd: float, rw: int, wrows: int = 512,
                           tile: int = TILE):
    """Plain PyTorch version of :func:`bpr_pool_step_v8`."""
    P = Hpool.shape[0]
    rows = rowsw.reshape(-1).long()
    rj = rjs.reshape(-1).long()
    inpool = (rj >= 0) & (rj < P)
    hj = torch.where(inpool[:, None], Hpool[rj.clamp(0, P - 1)], 0.0)
    SW, Q = _fused_math(Du_dec, Hi, hj, K, wd)
    keep = _window_keep(rows, starts, counts, rw=rw, wrows=wrows, tile=tile,
                        B=Hi.shape[0])
    Aw = torch.zeros((rw, LANES), dtype=SW.dtype, device=SW.device)
    Aw.index_add_(0, rows[keep], SW[keep])
    home = keep & inpool
    Apool = torch.zeros((P, LANES), dtype=Q.dtype, device=Q.device)
    Apool.index_add_(0, rj[home], Q[home])
    return Aw, Apool, Q


def bpr_pool_step_v8(rowsw, rjs, Du_dec, Hi, Hpool, starts, counts, *,
                     K: int, wd: float, rw: int, wrows: int = 512,
                     tile: int = TILE):
    """Shared-negative-pool fused step.

    Args (beyond :func:`bpr_range_step_v7`'s):
      rjs: int32 per-sample POOL slots, ``B`` elements (``j[b] =
        pool[rjs[b]]``).
      Hpool: (P, 128) gathered pool rows ``Hp[pool]``.

    Returns:
      Aw: (rw, 128) the W-side sums, the loss sum on lane 127.
      Apool: (P, 128) the pool-side H products (``sig*wu`` with the live
        counts at lane K), each sample once; scatter them as
        ``Hacc.index_add_(0, pool, Apool)``.  The kernel sums them with
        device-memory atomics, in an order that changes from run to run.
      Q: (B, 128) compact H-side product for the i-side accumulation,
        every sample's row.

    The kernel sums ``Aw`` in stream order and asserts that the rows it
    keeps are non-decreasing (the rows are ascending); a failed
    device-side assert leaves the CUDA context unusable.
    """
    B = Hi.shape[0]
    P = Hpool.shape[0]
    _check_streams(B, tile, rowsw, rjs)
    if not supports_v8(K, rw, wrows, P):
        raise ValueError("v8 gate: v7 gates plus P a positive multiple "
                         f"of 128 <= {POOL_MAX}")
    if not (Du_dec.shape == Hi.shape == (B, LANES)) \
            or Hpool.shape != (P, LANES):
        raise ValueError("Du_dec and Hi must be (B, 128), Hpool (P, 128)")
    if Hi.device.type == "cpu":
        return bpr_pool_step_v8_plain(rowsw, rjs, Du_dec, Hi, Hpool, starts,
                                      counts, K=K, wd=wd, rw=rw,
                                      wrows=wrows, tile=tile)
    if Hi.device.type != "cuda":
        raise ValueError(f"bpr_pool_step_v8 runs on cpu or cuda, not "
                         f"{Hi.device}")
    dev = Hi.device
    _check_range_cuda(dev, rowsw, ((Du_dec, "Du_dec"), (Hi, "Hi"),
                                   (Hpool, "Hpool")), starts, counts,
                      rw // wrows)
    _kernels.require(rjs, "rjs", torch.int32, dev)
    Aw = torch.empty((rw, LANES), dtype=torch.float32, device=dev)
    Apool = torch.zeros((P, LANES), dtype=torch.float32, device=dev)
    Q = torch.empty_like(Hi)
    nbytes = sa.segment_plan(B, rw, LANES)["scratch_bytes"]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _kernels.launch("bpr_pool_step_v8", dev,
            rowsw, rjs, Du_dec, Hi, Hpool, starts, counts, Aw, Apool, Q,
            scratch, nbytes, B, rw, wrows, tile, P, int(K), pk.num_slots(K),
            pk.count_base(K), float(wd))
    return Aw, Apool, Q


def fused_step_twin(version: int, rowsw, *, rw: int, wrows: int = 512,
                    tile: int = TILE, part: int, zero_gap: int, starts=None,
                    counts=None, cs=None, cn=None, rjs=None,
                    P: int = 0) -> dict:
    """The fused step kernels' partition (v6 with ``cs``/``cn``, v7 and v8
    with ``starts``/``counts``, v8 also ``rjs`` and ``P``), in Python, with
    ``part`` and ``zero_gap`` as :func:`~.sorted_accum.segment_plan` gives
    them: part ``p`` (samples ``[p part, (p + 1) part)``) writes the Q row
    of each of its samples, cuts its kept samples into the runs of
    :func:`~.sorted_accum.segment_twin` (a sample that is not kept counts
    as a sentinel there) and, for v8, adds the Q of each kept sample whose
    slot lies in ``[0, P)`` into that Apool row.  A sample is kept by the
    kernel's test, written here as it is there: its row lies in ``[0,
    rw)`` and
    - v7, v8: the sample in ``[st, en)`` of the row's window, ``st =
      max(starts[w], 0)`` and ``en = min(st + ceil(counts[w] / tile) tile,
      B)`` if ``counts[w] > 0``, else ``st``;
    - v6: the row in ``[h wrows, (h + 1) wrows + CROWS)``, ``h`` the home
      block of the part's chunk ``c = p part // tile`` (``tile`` a
      multiple of ``part``): the last block ``h`` with ``cs[h] <= c``, if
      ``c < cs[h] + cn[h]``.  A part whose chunk has no home block keeps
      nothing and writes zeros to its Q rows.

    Returns :func:`~.sorted_accum.segment_twin`'s dict (``writes``,
    ``carried``, ``into`` and the counts) plus ``keep`` (``[B]`` bool),
    ``q_writes`` (``[B]``, stores of each Q row), ``q_zero`` (``[B]``
    bool, the Q rows stored as zeros) and, for v8, ``pool_adds`` (``[P]``,
    Q rows added into each Apool row) with ``pool_from`` (``[B]``, times
    each sample's Q is added into Apool)."""
    rows = np.asarray(rowsw).reshape(-1).astype(np.int64)
    B = rows.size
    b = np.arange(B)
    inside = (rows >= 0) & (rows < rw)
    q_zero = np.zeros(B, bool)
    if version == 6:
        if tile % part:
            raise ValueError("v6 needs tile a multiple of part")
        cs = np.asarray(cs).astype(np.int64)
        cn = np.asarray(cn).astype(np.int64)
        keep = np.zeros(B, bool)
        for a in range(0, B, part):
            c = a // tile
            h = np.searchsorted(cs, c, side="right") - 1
            idx = b[a:a + part]
            if h < 0 or c >= cs[h] + cn[h]:
                q_zero[idx] = True
                continue
            r = rows[idx]
            keep[idx] = inside[idx] & (r >= h * wrows) \
                & (r < (h + 1) * wrows + CROWS)
    else:
        starts = np.asarray(starts).astype(np.int64)
        counts = np.asarray(counts).astype(np.int64)
        w = np.where(inside, rows, 0) // wrows
        st = np.maximum(starts[w], 0)
        cnt = counts[w]
        en = np.where(cnt > 0, np.minimum(st + -(-cnt // tile) * tile, B),
                      st)
        keep = inside & (b >= st) & (b < en)
    out = sa.segment_twin(np.where(keep, rows, -1), rw, part, zero_gap)
    q_writes = np.zeros(B, np.int64)
    for a in range(0, B, part):
        q_writes[a:a + part] += 1
    out = dict(out, keep=keep, q_writes=q_writes, q_zero=q_zero)
    if version != 8:
        return out
    rj = np.asarray(rjs).reshape(-1).astype(np.int64)
    add = keep & (rj >= 0) & (rj < P)
    return dict(out, pool_from=add.astype(np.int64),
                pool_adds=np.bincount(rj[add], minlength=P))
