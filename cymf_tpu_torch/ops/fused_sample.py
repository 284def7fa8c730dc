"""Fused BPR sample phase of the packed v4 and v5 pipelines.

Port of `cymf_tpu/ops/fused_sample.py` (``decorate``,
``bpr_sample_phase`` and ``bpr_sample_phase_v5``).  Between the table
gathers and the sorted
accumulations, one pass computes per sample the user's slot extraction,
the pairwise score and loss (`cymf/model.pyx:54-60`), the
shared sigmoid factor (`model.pyx:78`), the lane-placed W-side product
``SW`` and the compact H-side product ``Q`` that both item streams share.
On a CUDA tensor :func:`bpr_sample_phase` launches the hand-written kernel
of ``csrc/bpr_sample.cu`` and :func:`bpr_sample_phase_v5` that of
``csrc/bpr_fused.cu``; on a CPU tensor each runs its ``_plain`` version.
Both kernels share one device function for the per-sample math
(``csrc/bpr_math.cuh``), and the plain versions share
:func:`sample_math_plain`.

``WROWS_A`` (v5's expansion window) and ``TILE`` (its sample tile) are
part of the data gate of ``packed_epoch.engine_version`` and of
``prep_static``'s window starts, so the port keeps them as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels
from . import packed as pk

LANES = 128
# v5's sample tile: one W expansion window per TILE u-sorted samples
TILE = 512
# W rows of a tile's expansion window.  A tile of TILE u-sorted samples
# spans at most min(ceil(TILE / s) + 1, rw) packed rows when its users are
# consecutive; the worst supported case (s = 2) spans 257, so 264 covers
# it.  Tables smaller than this use the whole table as the window.
WROWS_A = 264


def decorate(gathered: torch.Tensor, slot: torch.Tensor, mf: torch.Tensor,
             K: int) -> torch.Tensor:
    """Gathered packed W rows ``[B, 128]`` -> the sample kernel's input:
    payload lanes ``[0, cb)`` pass through, lanes ``>= cb`` become
    ``mf * onehot(cb + slot)``.  Works IN PLACE on ``gathered`` (a fresh
    gather buffer on the main path) and returns it."""
    cb = pk.count_base(K)
    gathered[:, cb:] = 0
    ar = torch.arange(gathered.shape[0], device=gathered.device)
    gathered[ar, cb + slot.long()] = mf.to(gathered.dtype)
    return gathered


def sample_math_plain(Du, Di, Dj, *, K: int, wd: float, cmask_hi: int):
    """The per-sample math of every packed BPR kernel, written as the TPU
    kernels' lane rotations (``torch.roll``): ``(SW, Q, loss)`` with the
    per-sample loss ``(B, 1)``.  The count channel is lanes ``[cb,
    cmask_hi)``: v4 takes every lane from ``cb`` on (128), v5-v8 the ``s``
    slot lanes."""
    s, cb = pk.num_slots(K), pk.count_base(K)
    lane = torch.arange(LANES, device=Du.device)
    paymask = (lane < K).to(Du.dtype)
    cmask = ((lane >= cb) & (lane < cmask_hi)).to(Du.dtype)
    sel = Du[:, cb:cb + s]                      # mask * onehot(slot)
    wu = sel[:, :1] * Du
    for c in range(1, s):
        wu = wu + sel[:, c:c + 1] * torch.roll(Du, -c * K, dims=1)
    wu = wu * paymask
    diff = Di - Dj
    x = torch.sum(wu * diff, dim=1, keepdim=True)
    sig = torch.sigmoid(-x)
    mcol = torch.sum(Du * cmask, dim=1, keepdim=True)   # = mask
    l2 = torch.sum(wu * wu + Di * Di + Dj * Dj, dim=1, keepdim=True)
    loss = (-F.logsigmoid(x) + wd * l2) * mcol
    vals = sig * diff
    SW = Du * cmask + sel[:, :1] * vals
    for c in range(1, s):
        SW = SW + sel[:, c:c + 1] * torch.roll(vals, c * K, dims=1)
    Q = sig * wu + mcol * (lane == K).to(Du.dtype)
    return SW, Q, loss


def bpr_sample_phase_plain(Du, Di, Dj, *, K: int, wd: float):
    """Plain PyTorch version of :func:`bpr_sample_phase`."""
    SW, Q, loss = sample_math_plain(Du, Di, Dj, K=K, wd=wd, cmask_hi=LANES)
    return SW, Q, loss.sum()


def bpr_sample_phase(Du, Di, Dj, *, K: int, wd: float):
    """Decorated W gather + raw logical H gathers -> ``(SW, Q, loss)``.

    ``SW`` is the lane-placed W-side product ``sig * (hi - hj)`` with the
    user's count channel, ready for the packed-row accumulation.  ``Q`` is
    ``sig * wu`` on the payload lanes with the live-sample mask at lane
    ``K``; both item-side accumulations read from it.  ``loss`` is the
    step's loss sum as a 0-d tensor (the TPU kernel's (8, 128) loss block
    is a layout artifact of its grid and has no counterpart here).

    All three inputs are float32 ``(B, 128)``.  A CUDA input launches the
    kernel (and counts the launch); a CPU input runs the plain version.
    """
    if not (Du.shape == Di.shape == Dj.shape) or Du.dim() != 2 \
            or Du.shape[1] != LANES:
        raise ValueError("Du, Di, Dj must all be (B, 128)")
    if not pk.packable(K):
        raise ValueError(f"K={K} does not fit the packed layout")
    if Du.device.type == "cpu":
        return bpr_sample_phase_plain(Du, Di, Dj, K=K, wd=wd)
    if Du.device.type != "cuda":
        raise ValueError(f"bpr_sample_phase runs on cpu or cuda, not "
                         f"{Du.device}")
    dev = Du.device
    for t, name in ((Du, "Du"), (Di, "Di"), (Dj, "Dj")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    B = Du.shape[0]
    lib = _kernels.lib()
    SW = torch.empty_like(Du)
    Q = torch.empty_like(Du)
    partials = torch.empty(max(lib.cymf_bpr_sample_blocks(B), 1),
                           dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch("bpr_sample_phase", dev, Du, Di, Dj, SW, Q, partials,
                    loss, B, int(K), pk.num_slots(K), pk.count_base(K),
                    float(wd))
    return SW, Q, loss


def expand_rows(Wp, rows, start, win: int, Dj_dec, K: int):
    """The v5/v6 W expansion, as the TPU kernels' one-hot contraction over
    a window gives it: per sample, ``Du``'s payload lanes ``[0, cb)`` are
    W row ``rows[b]`` if it lies in ``[start[b], start[b] + win)`` and
    zero otherwise, its count channel ``[cb, cb + s)`` comes from the
    decorated j rows, and ``hj`` is their lanes ``< K``.  Returns
    ``(Du, hj)``."""
    s, cb = pk.num_slots(K), pk.count_base(K)
    rows = rows.long()
    lane = torch.arange(LANES, device=Wp.device)
    inwin = (rows >= start) & (rows < start + win)
    W = Wp.index_select(0, rows.clamp(0, Wp.shape[0] - 1))
    Du = torch.where(inwin[:, None] & (lane < cb), W, 0.0)
    Du = Du + Dj_dec * ((lane >= cb) & (lane < cb + s)).to(Dj_dec.dtype)
    return Du, Dj_dec * (lane < K).to(Dj_dec.dtype)


def _v5_window(K: int, rw: int, tile: int) -> int:
    """v5's expansion window for an ``rw``-row table; raises as the JAX
    wrapper does where it cannot cover a tile."""
    s = pk.num_slots(K)
    if s < 2:
        raise ValueError("v5 expansion requires >= 2 slots per row")
    win = min(WROWS_A, rw)
    if win < min(-(-tile // s) + 1, rw):
        raise ValueError("expansion window cannot cover a sample tile")
    return win


def bpr_sample_phase_v5_plain(Wp, wstart, rowsw, Di, Dj_dec, *, K: int,
                              wd: float, tile: int = TILE):
    """Plain PyTorch version of :func:`bpr_sample_phase_v5`."""
    win = _v5_window(K, Wp.shape[0], tile)
    rows = rowsw.reshape(-1)
    start = wstart.long().repeat_interleave(tile)
    Du, hj = expand_rows(Wp, rows, start, win, Dj_dec, K)
    SW, Q, loss = sample_math_plain(Du, Di, hj, K=K, wd=wd,
                                    cmask_hi=pk.count_base(K)
                                    + pk.num_slots(K))
    return SW, Q, loss.sum()


def bpr_sample_phase_v5(Wp, wstart, rowsw, Di, Dj_dec, *, K: int, wd: float,
                        tile: int = TILE):
    """v5 sample phase: the W rows are read in the kernel, not gathered.

    Each tile of ``tile`` u-sorted samples takes its W rows from the window
    ``[wstart[t], wstart[t] + min(WROWS_A, rw))`` of the packed table; a
    row outside it counts as zeros (the TPU kernel's one-hot expansion).
    The mask and slot decoration rides on the j rows' count lanes
    (``decorate(Hp[j], slot, mf, K)``).

    Args:
      Wp: (rw, 128) packed user table.
      wstart: int32[B / tile] per-tile window starts
        (``clip(phys[t * tile], 0, rw - WROWS_A)``, host-computed).
      rowsw: int32 per-sample packed rows, ``B`` elements (the JAX
        package's folded ``(B/128, 128)`` layout is a free view).
      Di: (B, 128) gathered item rows ``Hp[i]``.
      Dj_dec: (B, 128) gathered and decorated negative rows.

    Returns ``(SW, Q, loss)`` as :func:`bpr_sample_phase`.  A CUDA input
    launches the kernel (and counts the launch); a CPU input runs
    :func:`bpr_sample_phase_v5_plain`.
    """
    B = Di.shape[0]
    if Di.shape != Dj_dec.shape or Di.dim() != 2 or Di.shape[1] != LANES \
            or Wp.dim() != 2 or Wp.shape[1] != LANES:
        raise ValueError("Wp, Di and Dj_dec must be (rows, 128)")
    if B % tile:
        raise ValueError("B must be a multiple of tile")
    if not pk.packable(K):
        raise ValueError(f"K={K} does not fit the packed layout")
    win = _v5_window(K, Wp.shape[0], tile)
    if Di.device.type == "cpu":
        return bpr_sample_phase_v5_plain(Wp, wstart, rowsw, Di, Dj_dec, K=K,
                                         wd=wd, tile=tile)
    if Di.device.type != "cuda":
        raise ValueError(f"bpr_sample_phase_v5 runs on cpu or cuda, not "
                         f"{Di.device}")
    dev = Di.device
    for t, name in ((Wp, "Wp"), (Di, "Di"), (Dj_dec, "Dj_dec")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    _kernels.require(wstart, "wstart", torch.int32, dev, ndim=1)
    _kernels.require(rowsw, "rowsw", torch.int32, dev)
    if wstart.numel() != B // tile or rowsw.numel() != B:
        raise ValueError("wstart must hold B / tile starts, rowsw B rows")
    lib = _kernels.lib()
    SW = torch.empty_like(Di)
    Q = torch.empty_like(Di)
    partials = torch.empty(max(lib.cymf_bpr_v5_blocks(B), 1),
                           dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch("bpr_sample_phase_v5", dev, Wp, wstart, rowsw, Di,
                    Dj_dec, SW, Q, partials, loss, B, win, tile, int(K),
                    pk.num_slots(K), pk.count_base(K), float(wd))
    return SW, Q, loss
