"""Probe kernels P1-P3: measurements beside the BPR step's kernels.

Ports of the three Pallas kernels that live in the JAX package's
``scripts/`` (the numbering is ``PERF.md``'s, not the scripts' own):

- P1, :func:`phase_v4r` (``scripts/r5_kernel_variant.py::phase_v4r``):
  the v4 sample phase (#1, :func:`~.fused_sample.bpr_sample_phase`)
  with two lane reductions instead of three.  It asks whether a leaner
  op mix moves #1.  Its plain form is #1's;
- P2, :func:`copy_phase` (``scripts/r5_probes.py::copy_phase``): #1's
  reads and writes with no math, the streaming floor under #1;
- P3, :func:`gather_rows` (``scripts/roofline_gather.py::pallas_gather``):
  a row gather, to ask whether torch's gathers sit at the memory wall.
  The library call it is timed against is ``torch.index_select``.

On a CUDA tensor each launches its hand-written kernel of
``csrc/probes.cu``; on a CPU tensor each runs its plain version.  Left
behind: P3's DMA semaphores and ``q`` as a Mosaic DMA queue depth (the
CUDA form keeps ``rows_in_flight``, the whole rows a warp loads before it
stores them, as its own design choice), and the scripts' ``lax.scan``
timing harnesses (``chip_smoke.py`` times the kernels with CUDA events).
"""

from __future__ import annotations

import functools

import torch

from . import _kernels
from . import packed as pk
from .fused_sample import LANES, bpr_sample_phase_plain

ROWS_IN_FLIGHT = (1, 2, 4, 8, 16)
# P3's sizing (gather_plan): warps a block (csrc/probes.cu's
# GATHER_THREADS / 32), and the float4 a lane holds of a batch at most
GATHER_WARPS, MAX_LANE_FLOAT4 = 8, 32


def _three_tiles(Du, Di, Dj, what: str) -> None:
    if not (Du.shape == Di.shape == Dj.shape) or Du.dim() != 2 \
            or Du.shape[1] != LANES:
        raise ValueError(f"{what}: Du, Di, Dj must all be (B, 128)")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises elsewhere."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return True


def phase_v4r_plain(Du, Di, Dj, *, K: int, wd: float):
    """Plain version of :func:`phase_v4r`: #1's."""
    return bpr_sample_phase_plain(Du, Di, Dj, K=K, wd=wd)


def phase_v4r(Du, Di, Dj, *, K: int, wd: float):
    """P1: :func:`~.fused_sample.bpr_sample_phase`'s function, ``(SW, Q,
    loss)``, with the mask column riding the x reduction and the l2 term
    summed straight into the loss.  SW and Q equal #1's; the loss agrees
    to float32 round-off (another grouping).  The script masks the item
    rows' squares to lanes ``< K``; logical item rows are zero there, so
    the port sums whole rows, as #1 does."""
    _three_tiles(Du, Di, Dj, "phase_v4r")
    if not pk.packable(K):
        raise ValueError(f"K={K} does not fit the packed layout")
    if not _on_card(Du, "phase_v4r"):
        return phase_v4r_plain(Du, Di, Dj, K=K, wd=wd)
    dev = Du.device
    for t, name in ((Du, "Du"), (Di, "Di"), (Dj, "Dj")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    B = Du.shape[0]
    SW = torch.empty_like(Du)
    Q = torch.empty_like(Du)
    partials = torch.empty(max(_kernels.lib().cymf_phase_v4r_blocks(B), 1),
                           dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch("phase_v4r", dev, Du, Di, Dj, SW, Q, partials, loss, B,
                    int(K), pk.num_slots(K), pk.count_base(K), float(wd))
    return SW, Q, loss


def copy_phase_plain(Du, Di, Dj):
    """Plain version of :func:`copy_phase`."""
    return Du + Di, Di - Dj, torch.zeros((8, LANES), dtype=Du.dtype,
                                         device=Du.device)


def copy_phase(Du, Di, Dj):
    """P2: ``(Du + Di, Di - Dj, zeros(8, 128))`` from three float32 ``(B,
    128)`` tiles: #1's bytes with no math, the script's (8, 128) loss block
    included."""
    _three_tiles(Du, Di, Dj, "copy_phase")
    if not _on_card(Du, "copy_phase"):
        return copy_phase_plain(Du, Di, Dj)
    dev = Du.device
    for t, name in ((Du, "Du"), (Di, "Di"), (Dj, "Dj")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    SW = torch.empty_like(Du)
    Q = torch.empty_like(Du)
    lossb = torch.empty((8, LANES), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _kernels.launch("copy_phase", dev, Du, Di, Dj, SW, Q, lossb, Du.numel(),
                    sms)
    return SW, Q, lossb


def gather_plan(B: int, W: int, sms: int, *, rows_in_flight: int = 8,
                blocks_per_sm: int = 1) -> dict:
    """P3's launch for ``B`` rows of width ``W`` (floats, a multiple of 4)
    on ``sms`` SMs, ``blocks_per_sm`` blocks of ``GATHER_WARPS`` warps
    resident on each (the kernel's occupancy): ``lane4``, the float4 a lane
    holds of a row (the least power of two up to 8 whose 32 lanes cover
    it; wider rows take ``passes`` passes), ``rows`` a warp's batch
    (``rows_in_flight``, fewer where a lane would hold more than
    ``MAX_LANE_FLOAT4`` float4), ``batches``, and ``blocks``, persistent:
    no more than are resident, nor than the batches need."""
    if W < 4 or W % 4:
        raise ValueError(f"table width must be a multiple of 4, got {W}")
    if rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError(f"rows_in_flight must be one of {ROWS_IN_FLIGHT}")
    w4 = W // 4
    lane4 = 1
    while lane4 < 8 and 32 * lane4 < w4:
        lane4 *= 2
    rows = min(rows_in_flight, MAX_LANE_FLOAT4 // lane4)
    batches = -(-B // rows)
    blocks = min(-(-batches // GATHER_WARPS), max(blocks_per_sm, 1) * sms)
    return dict(lane4=lane4, passes=-(-w4 // (32 * lane4)), rows=rows,
                batches=batches, blocks=blocks)


@functools.cache
def _gather_blocks_per_sm(device_index: int, rows: int, lane4: int) -> int:
    """The kernel's resident blocks an SM on the card ``device_index``
    (the CUDA occupancy API), asked once a card and instantiation."""
    with torch.cuda.device(device_index):
        n = _kernels.lib().cymf_gather_rows_occupancy(rows, lane4)
    if n < 0:
        _kernels.check(-n, "gather_rows")
    return n


def gather_rows_plain(T, idx):
    """Plain version of :func:`gather_rows`; raises ``ValueError`` for an
    id outside ``[0, R)``."""
    ids = idx.long()
    if ids.numel() and bool(((ids < 0) | (ids >= T.shape[0])).any()):
        raise ValueError(f"gather_rows_plain: ids outside [0, {T.shape[0]})")
    return T[ids]


def gather_rows(T, idx, *, rows_in_flight: int = 8):
    """P3: ``out[k] = T[idx[k]]`` for a float32 ``(R, W)`` table (``W`` a
    multiple of 4) and int32 ``(B,)`` ids in ``[0, R)``.  On the card
    persistent warps walk batches of consecutive output rows, each loading
    all of a batch's rows before it stores any.  ``rows_in_flight`` (1, 2,
    4, 8 or 16) is that batch: the whole rows a warp keeps in flight,
    fewer where a lane would hold more than 32 float4 of them
    (:func:`gather_plan`).  An id outside ``[0, R)`` reads nothing and
    gives a zero row there, while the plain form raises."""
    if T.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows takes a (R, W) table and (B,) ids")
    if rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError(f"rows_in_flight must be one of {ROWS_IN_FLIGHT}")
    if not _on_card(T, "gather_rows"):
        return gather_rows_plain(T, idx)
    dev = T.device
    _kernels.require(T, "T", torch.float32, dev, ndim=2)
    _kernels.require(idx, "idx", torch.int32, dev, ndim=1)
    R, W = T.shape
    B = idx.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gather_plan(B, W, sms, rows_in_flight=rows_in_flight)
    per_sm = _gather_blocks_per_sm(dev.index, plan["rows"], plan["lane4"])
    plan = gather_plan(B, W, sms, rows_in_flight=rows_in_flight,
                       blocks_per_sm=per_sm)
    out = torch.empty((B, W), dtype=torch.float32, device=dev)
    _kernels.launch("gather_rows", dev, T, idx, out, B, R, W, plan["rows"],
                    plan["lane4"], plan["blocks"])
    return out
