"""Sorted gradient accumulation: the scatter-add of the packed BPR step.

Port of `cymf_tpu/ops/sorted_accum.py`.  The trainer keeps each batch's
target rows sorted and the host computes, per window of ``wrows`` output
rows, the sample range that can hit it (:func:`window_ranges`, verbatim).
On a CUDA tensor :func:`sorted_accum` and :func:`sorted_accum_dual`
launch the hand-written kernels of ``csrc/sorted_accum.cu`` (one CTA per
window, the window's accumulator in shared memory); on a CPU tensor they
run their plain PyTorch versions, an ``index_add_`` that needs no window
ranges.  Sums come in another order than a sequential scatter, so results
agree to float32 round-off, not bit for bit.

The TPU kernel's ``precision="split"`` bf16 hi+lo matmul and its window
starts pre-divided by 128 are Mosaic workarounds with no counterpart
here: the port accumulates in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

LANES = 128
# shared memory one CTA can use on Hopper (bytes)
MAX_SMEM = 232448


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


def _rows_flat(rows: torch.Tensor, n: int) -> torch.Tensor:
    flat = rows.reshape(-1)
    if flat.numel() != n:
        raise ValueError(f"{flat.numel()} row ids for {n} gradient rows")
    return flat


def _scatter_into(out: torch.Tensor, rows: torch.Tensor,
                  g: torch.Tensor) -> None:
    keep = (rows >= 0) & (rows < out.shape[0])
    out.index_add_(0, rows[keep].long(), g[keep])


def sorted_accum_plain(rows, g, starts, counts, *, r_pad: int,
                       wrows: int) -> torch.Tensor:
    """Plain version of :func:`sorted_accum`: ``out[rows[b]] += g[b]`` for
    rows in ``[0, r_pad)`` (the ``sorted_accum_reference`` of the JAX
    package).  ``starts``/``counts``/``wrows`` only bound where the kernel
    looks, so this form ignores them."""
    rows = _rows_flat(rows, g.shape[0])
    out = torch.zeros((r_pad, g.shape[1]), dtype=g.dtype, device=g.device)
    _scatter_into(out, rows, g)
    return out


def sorted_accum_dual_plain(rows_i, gi, starts_i, counts_i, rows_j, gj,
                            starts_j, counts_j, *, r_pad: int,
                            neg_lanes: int, wrows: int) -> torch.Tensor:
    """Plain version of :func:`sorted_accum_dual`."""
    rows_i = _rows_flat(rows_i, gi.shape[0])
    rows_j = _rows_flat(rows_j, gj.shape[0])
    sign = torch.ones(gi.shape[1], dtype=gi.dtype, device=gi.device)
    sign[:neg_lanes] = -1.0
    out = torch.zeros((r_pad, gi.shape[1]), dtype=gi.dtype, device=gi.device)
    _scatter_into(out, rows_i, gi * sign)
    _scatter_into(out, rows_j, gj)
    return out


def _check_shapes(g, r_pad: int, wrows: int) -> None:
    if r_pad % wrows:
        raise ValueError("r_pad must be a multiple of wrows")
    if g.dim() != 2:
        raise ValueError("gradients must be (B, width)")


def _check_cuda(rows, g, starts, counts, r_pad: int, wrows: int, what: str):
    """The kernel's contract: width 128 f32 rows, int32 row ids and
    window ranges, one window's accumulator in shared memory."""
    dev = g.device
    _kernels.require(g, f"{what} gradients", torch.float32, dev, ndim=2)
    if g.shape[1] != LANES:
        raise ValueError(f"the CUDA kernel takes width {LANES}, "
                         f"got {g.shape[1]}")
    if wrows * LANES * 4 > MAX_SMEM:
        raise ValueError(f"wrows={wrows} window does not fit shared memory")
    _kernels.require(rows, f"{what} rows", torch.int32, dev)
    for t, name in ((starts, "starts"), (counts, "counts")):
        _kernels.require(t, f"{what} {name}", torch.int32, dev, ndim=1)
        if t.numel() != r_pad // wrows:
            raise ValueError(f"{what} {name} must hold one entry per window")


def sorted_accum(rows, g, starts, counts, *, r_pad: int,
                 wrows: int = 256) -> torch.Tensor:
    """Accumulate ``g[b]`` into output row ``rows[b]``.

    Args:
      rows: int32 ascending target rows, any shape with ``B`` elements (the
        JAX package's folded ``(B/128, 128)`` layout is a free view here).
        Rows ``>= r_pad`` (padding sentinels) drop.
      g: float32 ``(B, width)`` gradient rows (width 128 on CUDA).
      starts/counts: int32 ``[r_pad // wrows]`` window ranges from
        :func:`window_ranges`.
      r_pad: output rows, a multiple of ``wrows``.

    Returns float32 ``(r_pad, width)``.  A CUDA input launches the kernel
    (and counts the launch); a CPU input runs :func:`sorted_accum_plain`.
    """
    _check_shapes(g, r_pad, wrows)
    if g.device.type == "cpu":
        return sorted_accum_plain(rows, g, starts, counts, r_pad=r_pad,
                                  wrows=wrows)
    if g.device.type != "cuda":
        raise ValueError(f"sorted_accum runs on cpu or cuda, not {g.device}")
    _check_cuda(rows, g, starts, counts, r_pad, wrows, "sorted_accum")
    rows = _rows_flat(rows, g.shape[0])
    out = torch.empty((r_pad, LANES), dtype=torch.float32, device=g.device)
    lib = _kernels.lib()
    with torch.cuda.device(g.device):
        err = lib.cymf_sorted_accum(
            rows.data_ptr(), g.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), out.data_ptr(), g.shape[0], r_pad, wrows,
            _kernels.stream(g.device))
    _kernels.check(err, "sorted_accum")
    _kernels.launches["sorted_accum"] += 1
    return out


def sorted_accum_dual(rows_i, gi, starts_i, counts_i, rows_j, gj, starts_j,
                      counts_j, *, r_pad: int, neg_lanes: int,
                      wrows: int = 256) -> torch.Tensor:
    """Two sorted streams into one buffer:
    ``scatter(rows_j, gj) + scatter(rows_i, gi * sign)`` with ``sign = -1``
    on lanes ``< neg_lanes`` and ``+1`` elsewhere, i.e. ``Aj - Ai`` on the
    payload lanes with the count lane adding.  Argument contracts are as
    :func:`sorted_accum`, once per stream."""
    _check_shapes(gi, r_pad, wrows)
    if gj.shape[1:] != gi.shape[1:]:
        raise ValueError("gradient widths must match")
    if gi.device.type == "cpu" and gj.device.type == "cpu":
        return sorted_accum_dual_plain(
            rows_i, gi, starts_i, counts_i, rows_j, gj, starts_j, counts_j,
            r_pad=r_pad, neg_lanes=neg_lanes, wrows=wrows)
    if gi.device.type != "cuda":
        raise ValueError(f"sorted_accum_dual runs on cpu or cuda, not "
                         f"{gi.device}")
    _check_cuda(rows_i, gi, starts_i, counts_i, r_pad, wrows, "i stream")
    _check_cuda(rows_j, gj, starts_j, counts_j, r_pad, wrows, "j stream")
    if gj.device != gi.device:
        raise ValueError("both streams must be on one device")
    rows_i = _rows_flat(rows_i, gi.shape[0])
    rows_j = _rows_flat(rows_j, gj.shape[0])
    out = torch.empty((r_pad, LANES), dtype=torch.float32, device=gi.device)
    lib = _kernels.lib()
    with torch.cuda.device(gi.device):
        err = lib.cymf_sorted_accum_dual(
            rows_i.data_ptr(), gi.data_ptr(), starts_i.data_ptr(),
            counts_i.data_ptr(), rows_j.data_ptr(), gj.data_ptr(),
            starts_j.data_ptr(), counts_j.data_ptr(), out.data_ptr(),
            gi.shape[0], gj.shape[0], r_pad, wrows, int(neg_lanes),
            _kernels.stream(gi.device))
    _kernels.check(err, "sorted_accum_dual")
    _kernels.launches["sorted_accum_dual"] += 1
    return out
