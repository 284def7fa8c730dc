"""Sorted gradient accumulation: the scatter-add of the packed BPR step.

Port of `cymf_tpu/ops/sorted_accum.py`.  The trainer keeps each batch's
target rows sorted and the host computes, per window of ``wrows`` output
rows, the sample range that can hit it (:func:`window_ranges`, verbatim).
On a CUDA tensor :func:`sorted_accum` and :func:`sorted_accum_dual`
launch the hand-written kernels of ``csrc/sorted_accum.cu``; on a CPU
tensor they run their plain PyTorch versions, an ``index_add_`` that needs
no window ranges.  Sums come in another order than a sequential scatter,
so results agree to float32 round-off, not bit for bit.

Both kernels are a sample-balanced segmented reduction: each warp sums
the runs of a part of consecutive samples, a second short pass joins the
runs that parts share (:func:`segment_plan` and :func:`dual_plan` read
the kernels' grid and scratch).  :func:`sorted_accum` (one stream) stores each run's sum, zeroes
the short gaps between a part's runs and, in the second pass, the rows
still unwritten (:func:`segment_twin` is its partition in Python).
:func:`sorted_accum_dual` runs the j stream as :func:`sorted_accum`
does (every row written once), then adds the i stream's run sums onto it
with atomics: a row gets at most one add, so the result is the same from
run to run (:func:`dual_twin`).  Both rely on the live
rows (those in ``[0, r_pad)``) being non-decreasing along each stream, and
the kernels assert it; rows outside ``[0, r_pad)`` may sit anywhere.  No
kernel reads the window ranges: the wrappers check them (the JAX
package's signature) and pass them nowhere.

Two forms, as in the JAX package: 128-lane rows (the packed pipelines,
launches counted as ``sorted_accum`` / ``sorted_accum_dual``) and rows of
any multiple of 128 lanes with an optional count granule
(``count_lanes=True``, the wide BPR engine; launches counted as
``sorted_accum_wide`` / ``sorted_accum_dual_wide``).

Left behind, with no counterpart here: the TPU kernel's
``precision="split"`` bf16 hi+lo matmul (the port accumulates in float32);
its window starts pre-divided by 128 (a Mosaic proof of DMA offset
divisibility); and its one-hot MXU contraction with double-buffered DMA
slots (a CUDA warp adds rows in registers as it reads them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _kernels

LANES = 128


def window_ranges(rows_sorted: np.ndarray, r_pad: int, wrows: int,
                  tile: int = 1024, align: int | None = None):
    """Host-side: per-window aligned [start, count) sample ranges.

    ``rows_sorted`` must be ascending; padding sentinel rows must be
    >= r_pad so no window's range covers them as matches.

    ``align=None`` (legacy) aligns starts down to ``tile`` — every
    chunk DMA trivially stays inside the tile-padded sample array, but
    a window reprocesses up to ``tile-1`` pre-window samples (~40%
    extra chunk traffic at ML-20M shapes).  ``align=128`` (the fold
    granularity of the lane-major rows arrays — slices must land on
    whole 128-lane groups) cuts that to < 128 samples per window; the
    few windows whose last chunk would overrun the padded length are
    re-anchored so their chunk grid ends exactly at it (still covering
    every window sample, at tile granularity)."""
    nw = r_pad // wrows
    bounds = np.arange(nw + 1, dtype=np.int64) * wrows
    edges = np.searchsorted(rows_sorted, bounds).astype(np.int64)
    if align is None:
        starts = (edges[:-1] // tile) * tile
        counts = edges[1:] - starts
        return starts.astype(np.int32), counts.astype(np.int32)
    if align % LANES or tile % align:
        raise ValueError("align must be a multiple of 128 dividing tile")
    Bp = -(-max(len(rows_sorted), 1) // tile) * tile
    starts = (edges[:-1] // align) * align
    counts = edges[1:] - starts
    nch = -(-counts // tile)
    over = starts + nch * tile > Bp
    if over.any():
        need = np.maximum(nch, -(-(Bp - edges[:-1]) // tile))
        starts = np.where(over, Bp - need * tile, starts)
        counts = edges[1:] - starts
    return starts.astype(np.int32), counts.astype(np.int32)


def pad_samples(rows_sorted: np.ndarray, sentinel: int, tile: int = 1024):
    """Host-side: pad sorted rows up to a tile multiple (sentinel >= r_pad
    so padding never matches a window) and fold to the (B/128, 128)
    lane-major layout the kernel expects.  No spare tile is needed: window
    starts are tile-aligned and the padded length is a tile multiple, so
    every DMA offset satisfies off + tile <= B."""
    n = len(rows_sorted)
    total = -(-max(n, 1) // tile) * tile
    out = np.full(total, sentinel, np.int32)
    out[:n] = rows_sorted
    return out.reshape(total // LANES, LANES)


def _plan(entry, what: str, keys: tuple, *args) -> dict:
    plan = (ctypes.c_longlong * len(keys))()
    _kernels.check(getattr(_kernels.lib(), entry)(
        *args, ctypes.addressof(plan)), what)
    return dict(zip(keys, plan))


@functools.lru_cache(maxsize=64)
def segment_plan(n: int, r_pad: int, width: int) -> dict:
    """The single-stream kernel's launch for ``n`` samples of ``width``
    lanes into ``r_pad`` rows, as ``csrc/segment.cuh::plan_segmented``
    chooses it: ``parts`` warps of ``part`` samples in ``blocks`` CTAs of
    ``share`` samples, ``zero_gap`` (the most rows a part zeroes between
    two of its runs; the second pass zeroes longer gaps) and the
    ``scratch_bytes`` the call needs.  Loads the kernel library."""
    return _plan("cymf_sorted_accum_plan", "sorted_accum plan",
                 ("part", "parts", "blocks", "share", "zero_gap",
                  "scratch_bytes"), n, r_pad, width)


@functools.lru_cache(maxsize=64)
def dual_plan(n_i: int, n_j: int, r_pad: int, width: int) -> dict:
    """The dual kernel's launch for ``n_i`` i-stream and ``n_j`` j-stream
    samples (``csrc/sorted_accum.cu::plan_dual``): ``parts_i`` and
    ``parts_j`` warps of ``part`` samples in ``blocks_i`` and ``blocks_j``
    CTAs of ``share`` samples, and the ``scratch_bytes`` the call needs.
    Loads the kernel library."""
    return _plan("cymf_sorted_accum_dual_plan", "sorted_accum_dual plan",
                 ("part", "parts_i", "parts_j", "blocks_i", "blocks_j",
                  "share", "scratch_bytes"), n_i, n_j, r_pad, width)


def _ordered_sum(g: np.ndarray, pieces: list) -> np.ndarray:
    """A run's float32 sum as a kernel forms it: each piece's rows added
    in stream order from zero, then the pieces added in order."""
    acc = None
    for idx in pieces:
        piece = np.add.accumulate(g[idx], axis=0, dtype=np.float32)[-1]
        acc = piece if acc is None else acc + piece
    return acc


def segment_twin(rows, r_pad: int, part: int, zero_gap: int, g=None,
                 add: bool = False) -> dict:
    """A segmented-reduction kernel's partition of one stream, in Python:
    which part sums each live sample into which row, and how often each
    output row is written, with ``part`` and ``zero_gap`` as
    :func:`segment_plan` gives them; ``add=True`` is the add policy of the
    dual kernel's i stream (no row is zeroed, and ``writes`` counts the
    run sums added to each row).  With ``g`` (``(n, width)`` float32) it
    also forms the run sums as the kernel does (:func:`_ordered_sum`).

    Pass 1: part ``p`` (samples ``[p part, (p + 1) part)``) cuts its live
    samples into pieces of one row each; a piece between its first and
    last is a whole run, stored at once; the first and the last go to
    scratch slots, with the part's first and last live row; the rows
    strictly between two of its pieces, if at most ``zero_gap``, are
    zeroed.  Pass 2: a part whose first piece starts a run (the last live
    row of the nearest earlier part with a live sample differs), and a
    part's last piece (when another than its first), store their row after
    adding the first pieces of the following parts while the run goes on,
    skipping parts with no live sample; every row not yet written is
    zeroed.

    Returns ``writes`` (``[r_pad]``, stores of each row, zeros included),
    ``carried`` (``[n]``, times each sample is summed into a stored row),
    ``into`` (``[n]``, that row, -1 for none), ``sums`` (with ``g``:
    ``(r_pad, width)``, each stored run's sum, zeros elsewhere; else
    None), and the plan's counts:
    ``parts``, ``runs``, ``joined`` (runs that pass 2 stores), ``longest``
    (samples of the longest run) and ``walk`` (most following parts whose
    first pieces one join adds).
    Raises ``ValueError`` if the live rows are not non-decreasing: the
    kernel's precondition."""
    rows = np.asarray(rows).reshape(-1).astype(np.int64)
    n = rows.size
    live = (rows >= 0) & (rows < r_pad)
    if (np.diff(rows[live]) < 0).any():
        raise ValueError("live rows must be non-decreasing along the stream")
    parts = -(-n // part)
    first = np.full(parts, -1, np.int64)
    last = np.full(parts, -1, np.int64)
    slots = {}
    writes = np.zeros(r_pad, np.int64)
    carried = np.zeros(n, np.int64)
    into = np.full(n, -1, np.int64)
    stats = dict(parts=parts, runs=0, joined=0, longest=0, walk=0)
    sums = None
    if g is not None:
        g = np.asarray(g, np.float32)
        sums = np.zeros((r_pad, g.shape[1]), np.float32)

    def store(row, pieces):
        samples = np.concatenate(pieces)
        writes[row] += 1
        carried[samples] += 1
        into[samples] = row
        stats["runs"] += 1
        stats["longest"] = max(stats["longest"], len(samples))
        if sums is not None:
            sums[row] = _ordered_sum(g, pieces)

    for p in range(parts):
        idx = np.flatnonzero(live[p * part:(p + 1) * part]) + p * part
        cuts = np.flatnonzero(np.diff(rows[idx])) + 1
        pieces = [(int(rows[s[0]]), s) for s in np.split(idx, cuts) if s.size]
        for k, (row, samples) in enumerate(pieces):
            if k and not add and row - pieces[k - 1][0] - 1 <= zero_gap:
                writes[pieces[k - 1][0] + 1:row] += 1
            if k == 0:
                slots[p, 0] = samples
            elif k == len(pieces) - 1:
                slots[p, 1] = samples
            else:
                store(row, [samples])
        if pieces:
            first[p], last[p] = pieces[0][0], pieces[-1][0]

    def emit(p, slot, row, walk):
        samples, q = [slots[p, slot]], p + 1
        while walk and q < parts:
            if first[q] >= 0:
                if first[q] != row:
                    break
                samples.append(slots[q, 0])
                if last[q] != row:
                    break
            q += 1
        stats["walk"] = max(stats["walk"], len(samples) - 1)
        stats["joined"] += 1
        store(row, samples)

    for p in range(parts):
        f = first[p]
        if f < 0:
            continue
        before = last[:p][first[:p] >= 0]
        if not before.size or before[-1] != f:
            emit(p, 0, f, last[p] == f)
        if last[p] != f:
            emit(p, 1, last[p], True)
    if not add:
        writes[writes == 0] += 1    # the zero fill: rows not yet written
    return dict(writes=writes, carried=carried, into=into, sums=sums,
                **stats)


def dual_twin(rows_i, gi, rows_j, gj, r_pad: int, part: int,
              zero_gap: int, neg_lanes: int,
              count_lanes: bool = False) -> dict:
    """The dual kernel, in Python: the j stream as :func:`segment_twin`
    stores it (every row written once: a run sum, a part's gap or the zero
    fill), then the i stream's parts under the add policy, each of its
    run sums added once onto the stored row, negated on lanes
    ``< neg_lanes`` (negation commutes with rounding, so negating the sum
    is negating its samples), and with ``count_lanes`` its length added
    on lane ``width``.

    Returns ``out`` (float32, ``(r_pad, width)`` or ``(r_pad, width +
    128)``, the sums as the kernel forms them: ``b + a``, the j stream's
    sum stored, the i stream's added), ``stores`` (``[r_pad]``, the j
    pass's writes of each row), ``adds`` (``[r_pad]``, the i stream's run
    sums added to each row), ``parts_i``, ``parts_j`` and each stream's
    twin (``i``, ``j``).  Raises ``ValueError`` if a stream's live rows
    are not non-decreasing."""
    gi, gj = np.asarray(gi, np.float32), np.asarray(gj, np.float32)
    width = gi.shape[1]
    sign = np.ones(width, np.float32)
    sign[:neg_lanes] = -1.0
    tj = segment_twin(rows_j, r_pad, part, zero_gap, g=gj)
    ti = segment_twin(rows_i, r_pad, part, zero_gap, g=gi * sign, add=True)
    out = np.zeros((r_pad, _out_width(width, count_lanes)), np.float32)
    out[:, :width] = tj["sums"]
    out[:, :width] += ti["sums"]
    if count_lanes:
        for t in (tj, ti):
            live = t["into"] >= 0
            out[:, width] += np.bincount(t["into"][live], minlength=r_pad)
    return dict(out=out, stores=tj["writes"], adds=ti["writes"],
                parts_i=ti["parts"], parts_j=tj["parts"], i=ti, j=tj)


def _rows_flat(rows: torch.Tensor, n: int) -> torch.Tensor:
    flat = rows.reshape(-1)
    if flat.numel() != n:
        raise ValueError(f"{flat.numel()} row ids for {n} gradient rows")
    return flat


def _scatter_into(out: torch.Tensor, rows: torch.Tensor, g: torch.Tensor,
                  count_lanes: bool) -> None:
    """``out[rows[b], :width] += g[b]`` for rows in ``[0, r_pad)``; with
    ``count_lanes`` also ``out[rows[b], width] += 1`` (the live count)."""
    keep = (rows >= 0) & (rows < out.shape[0])
    rows = rows[keep].long()
    width = g.shape[1]
    out[:, :width].index_add_(0, rows, g[keep])
    if count_lanes:
        out[:, width] += torch.bincount(rows, minlength=out.shape[0]).to(
            out.dtype)


def _out_width(width: int, count_lanes: bool) -> int:
    return width + LANES if count_lanes else width


def sorted_accum_plain(rows, g, starts, counts, *, r_pad: int,
                       wrows: int, count_lanes: bool = False
                       ) -> torch.Tensor:
    """Plain version of :func:`sorted_accum`: ``out[rows[b]] += g[b]`` for
    rows in ``[0, r_pad)`` (the ``sorted_accum_reference`` of the JAX
    package), plus a ``bincount`` of those rows with ``count_lanes``.
    ``starts``/``counts``/``wrows`` only bound where the kernel looks, so
    this form ignores them."""
    rows = _rows_flat(rows, g.shape[0])
    out = torch.zeros((r_pad, _out_width(g.shape[1], count_lanes)),
                      dtype=g.dtype, device=g.device)
    _scatter_into(out, rows, g, count_lanes)
    return out


def sorted_accum_dual_plain(rows_i, gi, starts_i, counts_i, rows_j, gj,
                            starts_j, counts_j, *, r_pad: int,
                            neg_lanes: int, wrows: int,
                            count_lanes: bool = False) -> torch.Tensor:
    """Plain version of :func:`sorted_accum_dual`."""
    rows_i = _rows_flat(rows_i, gi.shape[0])
    rows_j = _rows_flat(rows_j, gj.shape[0])
    sign = torch.ones(gi.shape[1], dtype=gi.dtype, device=gi.device)
    sign[:neg_lanes] = -1.0
    out = torch.zeros((r_pad, _out_width(gi.shape[1], count_lanes)),
                      dtype=gi.dtype, device=gi.device)
    _scatter_into(out, rows_i, gi * sign, count_lanes)
    _scatter_into(out, rows_j, gj, count_lanes)
    return out


def _check_shapes(g, r_pad: int, wrows: int) -> None:
    if r_pad % wrows:
        raise ValueError("r_pad must be a multiple of wrows")
    if g.dim() != 2:
        raise ValueError("gradients must be (B, width)")
    if g.shape[1] % LANES:
        raise ValueError(f"gradient width must be a multiple of {LANES}, "
                         f"got {g.shape[1]}")


def _check_cuda(rows, g, starts, counts, r_pad: int, wrows: int, what: str):
    """The kernel's contract: f32 rows, int32 row ids and window ranges."""
    dev = g.device
    _kernels.require(g, f"{what} gradients", torch.float32, dev, ndim=2)
    _kernels.require(rows, f"{what} rows", torch.int32, dev)
    for t, name in ((starts, "starts"), (counts, "counts")):
        _kernels.require(t, f"{what} {name}", torch.int32, dev, ndim=1)
        if t.numel() != r_pad // wrows:
            raise ValueError(f"{what} {name} must hold one entry per window")


def sorted_accum(rows, g, starts, counts, *, r_pad: int,
                 wrows: int = 512, count_lanes: bool = False
                 ) -> torch.Tensor:
    """Accumulate ``g[b]`` into output row ``rows[b]``.

    Args:
      rows: int32 target rows, any shape with ``B`` elements (the JAX
        package's folded ``(B/128, 128)`` layout is a free view here).
        Rows outside ``[0, r_pad)`` (padding sentinels, and with
        ``count_lanes`` the dead samples the caller routed there) drop and
        may sit anywhere; the others must be non-decreasing along the
        stream (the kernel's precondition: it fails a device-side assert
        otherwise, which leaves the CUDA context unusable).
      g: float32 ``(B, width)`` gradient rows, ``width`` a multiple of 128.
      starts/counts: int32 ``[r_pad // wrows]`` window ranges from
        :func:`window_ranges` (checked; the kernel needs no window).
      r_pad: output rows, a multiple of ``wrows``.
      count_lanes: append a 128-lane granule whose lane 0 holds each row's
        count of samples (the other 127 lanes zero).

    Returns float32 ``(r_pad, width)``, or ``(r_pad, width + 128)`` with
    ``count_lanes``.  A CUDA input launches the kernel (and counts the
    launch); a CPU input runs :func:`sorted_accum_plain`.
    """
    _check_shapes(g, r_pad, wrows)
    if g.device.type == "cpu":
        return sorted_accum_plain(rows, g, starts, counts, r_pad=r_pad,
                                  wrows=wrows, count_lanes=count_lanes)
    if g.device.type != "cuda":
        raise ValueError(f"sorted_accum runs on cpu or cuda, not {g.device}")
    _check_cuda(rows, g, starts, counts, r_pad, wrows, "sorted_accum")
    rows = _rows_flat(rows, g.shape[0])
    width = g.shape[1]
    out = torch.empty((r_pad, _out_width(width, count_lanes)),
                      dtype=torch.float32, device=g.device)
    plan = segment_plan(g.shape[0], r_pad, width)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=g.device)
    name = ("sorted_accum_wide" if count_lanes or width != LANES
            else "sorted_accum")
    _kernels.launch(name, g.device, rows, g, out, scratch,
                    plan["scratch_bytes"], g.shape[0], r_pad, width,
                    int(count_lanes), entry="cymf_sorted_accum")
    return out


def sorted_accum_dual(rows_i, gi, starts_i, counts_i, rows_j, gj, starts_j,
                      counts_j, *, r_pad: int, neg_lanes: int,
                      wrows: int = 512, count_lanes: bool = False
                      ) -> torch.Tensor:
    """Two sorted streams into one buffer:
    ``scatter(rows_j, gj) + scatter(rows_i, gi * sign)`` with ``sign = -1``
    on lanes ``< neg_lanes`` and ``+1`` elsewhere, i.e. ``Aj - Ai`` on the
    payload lanes; with ``count_lanes`` both streams' counts add on lane
    ``width``.  Argument contracts are as :func:`sorted_accum`, once per
    stream (the window ranges are checked, and the kernel reads none).
    The kernel's result is the same bits from call to call: each row gets
    the j stream's run sum (or zeros) stored, then at most one i-stream
    run sum added."""
    _check_shapes(gi, r_pad, wrows)
    if gj.shape[1:] != gi.shape[1:]:
        raise ValueError("gradient widths must match")
    if gi.device.type == "cpu" and gj.device.type == "cpu":
        return sorted_accum_dual_plain(
            rows_i, gi, starts_i, counts_i, rows_j, gj, starts_j, counts_j,
            r_pad=r_pad, neg_lanes=neg_lanes, wrows=wrows,
            count_lanes=count_lanes)
    if gi.device.type != "cuda":
        raise ValueError(f"sorted_accum_dual runs on cpu or cuda, not "
                         f"{gi.device}")
    _check_cuda(rows_i, gi, starts_i, counts_i, r_pad, wrows, "i stream")
    _check_cuda(rows_j, gj, starts_j, counts_j, r_pad, wrows, "j stream")
    if gj.device != gi.device:
        raise ValueError("both streams must be on one device")
    n_i, n_j = gi.shape[0], gj.shape[0]
    rows_i = _rows_flat(rows_i, n_i)
    rows_j = _rows_flat(rows_j, n_j)
    width = gi.shape[1]
    out = torch.empty((r_pad, _out_width(width, count_lanes)),
                      dtype=torch.float32, device=gi.device)
    plan = dual_plan(n_i, n_j, r_pad, width)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=gi.device)
    name = ("sorted_accum_dual_wide" if count_lanes or width != LANES
            else "sorted_accum_dual")
    _kernels.launch(name, gi.device, rows_i, gi, rows_j, gj, out, scratch,
                    plan["scratch_bytes"], n_i, n_j, r_pad, width,
                    int(neg_lanes), int(count_lanes),
                    entry="cymf_sorted_accum_dual")
    return out
