"""Packed fused GloVe engine and the GloVe sample phase.

Port of `cymf_tpu/ops/glove_epoch.py` for one device.  GloVe's whole
sample stream (triples, weights ``f = min((count/x_max)^alpha, 1)``,
``log(count)``, sort permutations, accumulation windows) is static per
fit, so :func:`prep_glove_static` runs once and every epoch replays it.

Layout (fused-bias mode only): the augmented central table
``Zc = [w | b_c | 1]`` is lane-packed (``ops/packed.py``, payload width
``Kp = K + 2``), the augmented context table ``Zx = [h | 1 | b_x]`` is
logical (payload lanes ``[0, Kp)``, live-count lane ``Kp``).  The
per-sample constants ride free lanes of the context stream
(:func:`decorate_x`): lane ``Kp`` carries ``-log(count)`` and lane
``Kp + 1`` carries ``f``.  The constant-one columns stay constant: their
gradient lanes are zeroed before the AdaGrad update, and with ones-init
accumulators a zero gradient is a bit-exact no-op.

:func:`glove_sample_phase` is also the sample phase of packed RelMF
(``ops/relmf_epoch.py``).  On a CUDA tensor it launches the hand-written
kernel of ``csrc/glove_sample.cu``; on a CPU tensor it runs
:func:`glove_sample_phase_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from . import packed as pk
from .fused_sample import decorate
from .packed_epoch import (TILE, PackedAdaGrad, _packed_windows, _pad_lanes,
                           _sorted_side)
from .sorted_accum import sorted_accum

LANES = 128


def augment_tables(W_central, central_bias, W_context, context_bias):
    """The fused-bias augmented layout, the column order the freeze masks
    of :func:`packed_glove_epoch` depend on::

        Zc = [w | b_central | 1]        Zx = [h | 1 | b_context]

    so ``Zc . Zx = w.h + b_c + b_x``.  Host-side numpy."""
    V1 = W_central.shape[0]
    V2 = W_context.shape[0]
    Zc = np.concatenate(
        [W_central, np.asarray(central_bias).reshape(V1, 1),
         np.ones((V1, 1))], axis=1)
    Zx = np.concatenate(
        [W_context, np.ones((V2, 1)),
         np.asarray(context_bias).reshape(V2, 1)], axis=1)
    return Zc, Zx


def supports_packed_glove(K: int) -> bool:
    """The augmented payload ``Kp = K + 2`` must pack (>= 1 slot) and the
    context decoration needs lanes ``Kp`` and ``Kp + 1`` free."""
    Kp = K + 2
    return pk.num_slots(Kp) >= 1 and Kp + 2 <= LANES


def decorate_x(gathered: torch.Tensor, f: torch.Tensor,
               logcnt: torch.Tensor, Kp: int) -> torch.Tensor:
    """Context-stream decoration: payload lanes ``[0, Kp)`` pass through,
    lane ``Kp`` := ``-logcnt`` (the score's dot product absorbs the
    subtraction), lane ``Kp + 1`` := ``f``, every other lane 0.  Works IN
    PLACE on ``gathered`` (a fresh gather buffer) and returns it."""
    gathered[:, Kp:] = 0
    gathered[:, Kp] = -logcnt.to(gathered.dtype)
    gathered[:, Kp + 1] = f.to(gathered.dtype)
    return gathered


def glove_sample_phase_plain(Du: torch.Tensor, Dx: torch.Tensor, *,
                             Kp: int):
    """Plain PyTorch version of :func:`glove_sample_phase`, written as the
    TPU kernel's lane rotations (``torch.roll``)."""
    s, cb = pk.num_slots(Kp), pk.count_base(Kp)
    lane = torch.arange(LANES, device=Du.device)
    paymask = (lane < Kp).to(Du.dtype)
    cmask = (lane >= cb).to(Du.dtype)
    sel = Du[:, cb:cb + s]                       # mask * onehot(slot)
    zc = sel[:, :1] * Du
    for c in range(1, s):
        zc = zc + sel[:, c:c + 1] * torch.roll(Du, -c * Kp, dims=1)
    zc = zc * paymask
    zx = Dx * paymask
    neglog = Dx[:, Kp:Kp + 1]
    fcol = Dx[:, Kp + 1:Kp + 2]
    mcol = torch.sum(Du * cmask, dim=1, keepdim=True)    # = live mask
    diff = torch.sum(zc * zx, dim=1, keepdim=True) + neglog
    qv = fcol * diff * mcol                  # f * diff, masked
    loss = 0.5 * qv * diff                   # 0.5 * f * diff^2 * mask
    vals = qv * zx
    SW = Du * cmask + sel[:, :1] * vals
    for c in range(1, s):
        SW = SW + sel[:, c:c + 1] * torch.roll(vals, c * Kp, dims=1)
    Q = qv * zc + mcol * (lane == Kp).to(Du.dtype)
    return SW, Q, loss.sum()


def glove_sample_phase(Du: torch.Tensor, Dx: torch.Tensor, *, Kp: int):
    """Decorated central gather + decorated context gather ->
    ``(SW, Q, loss)``.

    ``Du`` is a gathered packed central row with lanes ``>= cb`` set to
    ``mask * onehot(cb + slot)`` (:func:`~.fused_sample.decorate`); ``Dx``
    a logical context row decorated by :func:`decorate_x`.  Per row:
    ``diff = zc . zx - log(count)``, ``qv = f * diff * mask``.  ``SW`` is
    ``qv * zx`` placed in the central row's slot lanes with the count
    channel copied from ``Du``; ``Q`` is ``qv * zc`` on the payload lanes
    with the live mask at lane ``Kp``; ``loss`` is the step's
    ``sum(0.5 * qv * diff)`` as a 0-d tensor (the TPU kernel's (8, 128)
    loss block is a layout artifact of its grid).

    Both inputs are float32 ``(B, 128)``.  A CUDA input launches the
    kernel (and counts the launch); a CPU input runs the plain version.
    """
    if Du.shape != Dx.shape or Du.dim() != 2 or Du.shape[1] != LANES:
        raise ValueError("Du and Dx must both be (B, 128)")
    if not (pk.packable(Kp) and Kp + 2 <= LANES):
        raise ValueError(f"Kp={Kp} does not fit the packed layout with two "
                         "decoration lanes")
    if Du.device.type == "cpu":
        return glove_sample_phase_plain(Du, Dx, Kp=Kp)
    if Du.device.type != "cuda":
        raise ValueError(f"glove_sample_phase runs on cpu or cuda, not "
                         f"{Du.device}")
    dev = Du.device
    for t, name in ((Du, "Du"), (Dx, "Dx")):
        _kernels.require(t, name, torch.float32, dev, ndim=2)
    B = Du.shape[0]
    lib = _kernels.lib()
    SW = torch.empty_like(Du)
    Q = torch.empty_like(Du)
    partials = torch.empty(max(lib.cymf_glove_sample_blocks(B), 1),
                           dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch("glove_sample_phase", dev, Du, Dx, SW, Q, partials, loss,
                    B, int(Kp), pk.num_slots(Kp), pk.count_base(Kp))
    return SW, Q, loss


def prep_glove_static(c2, x2, cnt2, num_central: int, K: int, rw: int,
                      rh: int, wrows_w: int, wrows_h: int, x_max: float,
                      alpha: float, tile: int = TILE):
    """Once per fit (there are no per-epoch draws): live masks, sample
    weights ``f`` and ``log(count)``, central-side windows over the
    per-step-sorted stream, and the context-side sort, rows and windows.
    The JAX package's numpy code, verbatim.

    Returns ``(m2, f2, l2, winw, sx, rowsx, winx)``."""
    m2 = (c2.astype(np.int64) < num_central).astype(np.uint8)
    f2 = np.minimum((cnt2 / x_max) ** alpha, 1.0).astype(np.float32)
    l2 = np.log(np.maximum(cnt2, 1e-30)).astype(np.float32)
    winw = _packed_windows(c2, pk.num_slots(K + 2), rw, wrows_w, tile)
    sx, rowsx, winx = _sorted_side(x2, rh, wrows_h, tile)
    return m2, f2, l2, winw, sx, rowsx, winx


def glove_freeze_masks(K: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, 128) gradient masks that freeze the constant-one columns:
    slot-relative lane ``K + 1`` of the packed central table (and its
    count lanes), lane ``K`` and every lane ``>= Kp`` of the context
    table."""
    Kp = K + 2
    cb = pk.count_base(Kp)
    lane = torch.arange(LANES, device=device)
    freeze_c = _pad_lanes(((lane[:cb] % Kp) != K + 1)
                          .to(torch.float32)[None, :])
    freeze_x = ((lane < Kp) & (lane != K)).to(torch.float32)[None, :]
    return freeze_c, freeze_x


@torch.no_grad()
def packed_glove_epoch(Zc, Zx, oc, ox, c_steps, x_steps, m_steps, f_steps,
                       l_steps, sx_steps, rowsx_steps, winx, winw,
                       n_valid: int, *, lr: float, K: int, rw: int, rh: int,
                       wrows_w: int = 256, wrows_h: int = 256
                       ) -> torch.Tensor:
    """One epoch over S pre-sorted minibatches of fused-bias GloVe
    AdaGrad; returns the mean loss (0-d tensor, ``sum / max(n_valid,
    1)``).  ``Zc`` is the packed augmented central table (``rw`` rows,
    payload width ``Kp = K + 2``), ``Zx`` the logical augmented context
    table (``rh`` rows); both and their AdaGrad states ``oc``/``ox``
    (``{"accum"}``) are updated IN PLACE.  The streams come from
    :func:`prep_glove_static`, as device tensors:

      c_steps int32[S, B]    central ids, ascending within each step
                             (padding: 2**31-1, dropped)
      x_steps int32[S, B]    context ids, aligned with c
      m/f/l_steps [S, B]     live mask (uint8), weight f, log(count)
      sx/rowsx/winx          context-side sort, folded rows, windows
      winw int32[S, 2, rw/wrows_w]   central-side windows over c // s

    Update semantics: one synchronous AdaGrad step per minibatch with
    duplicate rows pre-combined by the windowed accumulation, ones-init
    accumulators, the constant-one columns frozen."""
    Kp = K + 2
    opt = PackedAdaGrad(lr)
    s = pk.num_slots(Kp)
    freeze_c, freeze_x = glove_freeze_masks(K, Zc.device)
    loss = torch.zeros((), dtype=torch.float32, device=Zc.device)
    for t in range(c_steps.shape[0]):
        c = c_steps[t]
        phys, slot = c // s, c % s
        # clamp only the gather index: padding sentinels stay >= rw so the
        # accumulation drops them, and their zero mask zeroes the kernel's
        # outputs
        Du = decorate(Zc.index_select(0, phys.clamp(max=rw - 1)), slot,
                      m_steps[t].to(torch.float32), Kp)
        Dx = decorate_x(Zx.index_select(0, x_steps[t]), f_steps[t],
                        l_steps[t], Kp)
        SW, Q, loss_t = glove_sample_phase(Du, Dx, Kp=Kp)
        loss += loss_t

        Ac = sorted_accum(phys, SW, winw[t, 0], winw[t, 1], r_pad=rw,
                          wrows=wrows_w)
        gc, _ = pk.split_counts(Ac, Kp)
        opt.update(Zc, oc, _pad_lanes(gc) * freeze_c, None)

        D = sorted_accum(rowsx_steps[t], Q.index_select(0, sx_steps[t]),
                         winx[t, 0], winx[t, 1], r_pad=rh, wrows=wrows_h)
        opt.update(Zx, ox, D * freeze_x, None)
    return loss / max(int(n_valid), 1)
