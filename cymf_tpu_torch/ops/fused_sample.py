"""Fused BPR sample phase of the packed v4 pipeline.

Port of `cymf_tpu/ops/fused_sample.py` (``decorate`` and
``bpr_sample_phase``).  Between the table gathers and the sorted
accumulations, one pass computes per sample the user's slot extraction,
the pairwise score and loss (`cymf/model.pyx:54-60`), the
shared sigmoid factor (`model.pyx:78`), the lane-placed W-side product
``SW`` and the compact H-side product ``Q`` that both item streams share.
On a CUDA tensor :func:`bpr_sample_phase` launches the hand-written kernel
of ``csrc/bpr_sample.cu``; on a CPU tensor it runs
:func:`bpr_sample_phase_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels
from . import packed as pk

LANES = 128


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


def bpr_sample_phase_plain(Du, Di, Dj, *, K: int, wd: float):
    """Plain PyTorch version of :func:`bpr_sample_phase`, written as the
    TPU kernel's lane rotations (``torch.roll``)."""
    s, cb = pk.num_slots(K), pk.count_base(K)
    lane = torch.arange(LANES, device=Du.device)
    paymask = (lane < K).to(Du.dtype)
    cmask = (lane >= cb).to(Du.dtype)
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
    with torch.cuda.device(dev):
        err = lib.cymf_bpr_sample_phase(
            Du.data_ptr(), Di.data_ptr(), Dj.data_ptr(), SW.data_ptr(),
            Q.data_ptr(), partials.data_ptr(), loss.data_ptr(), B, int(K),
            pk.num_slots(K), pk.count_base(K), float(wd),
            _kernels.stream(dev))
    _kernels.check(err, "bpr_sample_phase")
    _kernels.launches["bpr_sample_phase"] += 1
    return SW, Q, loss
