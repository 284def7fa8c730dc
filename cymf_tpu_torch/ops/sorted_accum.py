"""Sorted gradient accumulation: the scatter-add of the packed BPR step.

Port of `cymf_tpu/ops/sorted_accum.py`.  The trainer keeps each batch's
target rows sorted and the host computes, per window of ``wrows`` output
rows, the sample range that can hit it (:func:`window_ranges`, verbatim).
On a CUDA tensor :func:`sorted_accum` and :func:`sorted_accum_dual`
launch the hand-written kernels of ``csrc/sorted_accum.cu`` (one CTA per
slice of a window, its accumulator in shared memory: any ``wrows`` the JAX
package takes, its default 512 included); on a CPU tensor they run their
plain PyTorch versions, an ``index_add_`` that needs no window ranges.
Sums come in another order than a sequential scatter, so results agree to
float32 round-off, not bit for bit.

Two forms, as in the JAX package: 128-lane rows (the packed pipelines,
launches counted as ``sorted_accum`` / ``sorted_accum_dual``) and rows of
any multiple of 128 lanes with an optional count granule
(``count_lanes=True``, the wide BPR engine; launches counted as
``sorted_accum_wide`` / ``sorted_accum_dual_wide``).

Left behind, with no counterpart here: the TPU kernel's
``precision="split"`` bf16 hi+lo matmul (the port accumulates in float32);
its window starts pre-divided by 128 (a Mosaic proof of DMA offset
divisibility); and its one-hot MXU contraction with double-buffered DMA
slots (a CUDA CTA adds rows into shared memory as it reads them).
"""

from __future__ import annotations

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


def _wide(width: int, count_lanes: bool) -> bool:
    """Whether a call takes the wide kernel (and its launch count)."""
    if width == LANES and not count_lanes:
        return False
    if _kernels.lib().cymf_sorted_accum_max_slice(width,
                                                  int(count_lanes)) < 1:
        raise ValueError(f"width {width} does not fit a CTA's shared "
                         "memory")
    return True


def sorted_accum(rows, g, starts, counts, *, r_pad: int,
                 wrows: int = 512, count_lanes: bool = False
                 ) -> torch.Tensor:
    """Accumulate ``g[b]`` into output row ``rows[b]``.

    Args:
      rows: int32 ascending target rows, any shape with ``B`` elements (the
        JAX package's folded ``(B/128, 128)`` layout is a free view here).
        Rows ``>= r_pad`` (padding sentinels, and with ``count_lanes`` the
        dead samples the caller routed there) drop.
      g: float32 ``(B, width)`` gradient rows, ``width`` a multiple of 128.
      starts/counts: int32 ``[r_pad // wrows]`` window ranges from
        :func:`window_ranges`.
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
    if _wide(width, count_lanes):
        _kernels.launch("sorted_accum_wide", g.device, rows, g, starts,
                        counts, out, g.shape[0], r_pad, wrows, width,
                        int(count_lanes))
    else:
        _kernels.launch("sorted_accum", g.device, rows, g, starts, counts,
                        out, g.shape[0], r_pad, wrows)
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
    stream."""
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
    rows_i = _rows_flat(rows_i, gi.shape[0])
    rows_j = _rows_flat(rows_j, gj.shape[0])
    width = gi.shape[1]
    out = torch.empty((r_pad, _out_width(width, count_lanes)),
                      dtype=torch.float32, device=gi.device)
    args = (rows_i, gi, starts_i, counts_i, rows_j, gj, starts_j, counts_j,
            out, gi.shape[0], gj.shape[0], r_pad, wrows, int(neg_lanes))
    if _wide(width, count_lanes):
        _kernels.launch("sorted_accum_dual_wide", gi.device, *args, width,
                        int(count_lanes))
    else:
        _kernels.launch("sorted_accum_dual", gi.device, *args)
    return out
