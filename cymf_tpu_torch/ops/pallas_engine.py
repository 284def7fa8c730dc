"""The sequential small-catalog engine (``engine="pallas"``).

Port of `cymf_tpu/ops/pallas_engine.py`; the name is kept so that a reader
finds the counterpart, but nothing here is Pallas.  One launch walks a
whole stream of samples in order, ``group`` samples at a time, and applies
every sample's update to the tables before the next group reads them:
``group=1`` replays the reference's single-threaded update schedule
(`model.pyx:47-87` + `optimizer.pyx`) exactly, ``group=8`` is the analogue
of its 8 Hogwild threads (`bpr.pyx:162`): the samples of a group read one
snapshot, and where two write one row the later write wins.

On tables on the card, :func:`bpr_pallas_epoch`, :func:`relmf_pallas_epoch`
and :func:`glove_pallas_epoch` launch the hand-written kernels of
``csrc/seq_epoch.cu``; on tables on the CPU they run their plain PyTorch
versions (``*_plain``).  Both update the tables IN PLACE.

Layout: a fused row is ``[param Kp | state Kp ...]`` with ``Kp`` the
payload width rounded up to 4 (:func:`segment_width`): no state for sgd,
the accumulator (starting at one) for adagrad, ``m`` and ``v`` for adam.
The JAX package pads each segment to 128 lanes, a need of the TPU's
tiling; the lanes beyond the payload carry no gradient, so dropping them
changes nothing.  :func:`cymf_tpu_torch.convert.pallas_state_from_jax`
moves a JAX fused table into this layout.

Applicability: :func:`fits_vmem` is the JAX package's gate (tables and
optimizer state at 128 lanes a segment within 10 MiB), kept so that both
packages accept and refuse the same fits; it is not a limit of the card.

The kernels (one launch is one chain of dependent group steps, so they are
bound by latency): one block of ``group`` chain warps and a stager warp.
The stager stages the streams ahead of the chain in shared memory,
computes which of a group's writes win, and sums the loss terms, all off
the chain.  Where the tables live is the launch's *placement*, which the
C launch takes from ``csrc/seq_epoch.cu::seq_plan`` (the C entry
``cymf_seq_epoch_plan``; :func:`seq_placement` is its twin for the CPU
tests): 1, both fused tables in the block's shared memory, the TPU
kernel's VMEM residency, where they fit beside the staging ring; else 0,
device memory (through L2).  Both compute the same bits.  (A thread-block
cluster's distributed shared memory measured slower than L2 on the H100,
so it is no placement.)  The wrappers' private ``_placement`` forces one
(tests and ``chip_smoke.py`` only); a placement the tables do not fit
raises: nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _kernels

VMEM_BUDGET_BYTES = 10 * 1024 * 1024
LANES = 128
_N_STATE = {"sgd": 0, "adagrad": 1, "adam": 2}
# seq_placement's copy of csrc/seq_epoch.cu's constants: the opt-in
# shared memory of one block, and the staging ring's share of it (two
# slices of 256 samples: five streams, the loss terms and a flag byte a
# sample)
SMEM_MAX_BYTES = 232_448
RING_BYTES = 2 * 256 * (4 * 5 + 4 + 1)
TABLE_BYTES = SMEM_MAX_BYTES - RING_BYTES


def fits_vmem(num_rows_total: int, optimizer: str) -> bool:
    """The JAX engine's gate: the tables' footprint at 128 lanes a fused
    segment is at most :data:`VMEM_BUDGET_BYTES`."""
    width = LANES * (1 + _N_STATE[optimizer])
    return num_rows_total * width * 4 <= VMEM_BUDGET_BYTES


def seq_placement(rows_a: int, rows_b: int, row_bytes: int) -> int:
    """Where a sequential launch keeps two tables of ``rows_a`` and
    ``rows_b`` fused rows of ``row_bytes``: 1, the block's shared memory,
    where they fit beside the staging ring, else 0, device memory.  The
    twin of ``csrc/seq_epoch.cu::seq_plan`` for the CPU tests (the card
    tests hold the two equal): the launch itself applies the C plan, and
    ``cymf_seq_epoch_plan`` reports it on the card."""
    return int((rows_a + rows_b) * row_bytes <= TABLE_BYTES)


def segment_width(K: int) -> int:
    """Columns of one fused segment for a payload of ``K``: ``K`` rounded
    up to 4, so that a kernel reads a segment as ``float4``."""
    return -(-int(K) // 4) * 4


def pack_table(T: np.ndarray, optimizer: str, device) -> torch.Tensor:
    """``[rows, K]`` parameters -> fused ``[rows, (1 + n_state) * Kp]``
    float32 rows on ``device``.  Parameter columns beyond ``K`` are zero;
    adagrad accumulators start at ONE (`optimizer.pyx:69-70`), adam
    moments at zero."""
    T = np.asarray(T, np.float32)
    rows, K = T.shape
    if K > LANES:
        raise ValueError(f"pallas engine supports K <= {LANES}, got {K}")
    Kp = segment_width(K)
    out = np.zeros((rows, Kp * (1 + _N_STATE[optimizer])), np.float32)
    out[:, :K] = T
    if optimizer == "adagrad":
        out[:, Kp:2 * Kp] = 1.0
    return torch.from_numpy(out).to(device)


def unpack_table(P, K: int):
    """Fused rows -> ``[rows, K]`` parameters (a view)."""
    return P[:, :K]


def generate_epoch_negatives(rng: np.random.Generator, users: np.ndarray,
                             num_items: int, pos_keys_sorted: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``(negatives, keep)`` for a stream of users, on the host: one
    uniform draw per interaction, masked out where it hits a known positive
    (the reference skips those, `bpr.pyx:166-167`).  ``pos_keys_sorted``
    holds the sorted int64 keys ``u * num_items + i`` of the positives.
    The JAX package's function, draw for draw."""
    j = rng.integers(0, num_items, size=len(users)).astype(np.int32)
    keys = users.astype(np.int64) * num_items + j
    pos = np.searchsorted(pos_keys_sorted, keys)
    pos = np.minimum(pos, max(len(pos_keys_sorted) - 1, 0))
    if len(pos_keys_sorted):
        collide = pos_keys_sorted[pos] == keys
    else:
        collide = np.zeros(len(users), bool)
    return j, ~collide


# ---------------------------------------------------------------- plain --

def _split(rows, Kp: int, n_state: int):
    return rows[:, :Kp], [rows[:, Kp * (s + 1):Kp * (s + 2)]
                          for s in range(n_state)]


def _updated(param, state, g, optimizer, lr, beta1, beta2, eps):
    """One optimizer step on fused rows (`pallas_engine.py:116-130`)."""
    if optimizer == "adam":
        m, v = state
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * g * g
        p2 = param - lr * (m2 / (1 - beta1)) / (
            torch.sqrt(v2 / (1 - beta2)) + eps)
        return torch.cat([p2, m2, v2], dim=1)
    if optimizer == "adagrad":
        (a,) = state
        a2 = a + g * g
        p2 = param - lr * g * torch.rsqrt(a2)
        return torch.cat([p2, a2], dim=1)
    return param - lr * g


def _run_plain(tables, idx, vals, mask, group: int, rows_fn):
    """The sequential loop of the plain versions.  ``tables[k]`` is the
    table that index stream ``idx[k]`` addresses (BPR: W, H, H).  Per
    group: gather the snapshot rows, ``rows_fn(rows, vals, mf)`` -> (new
    rows per stream, loss terms), then write in the JAX kernel's order, for
    each kept sample t the streams in turn, so the last write to a row
    wins.  The loss sums a group's terms into a per-chunk sum, added to the
    total once per chunk.  Returns the loss sum, 0-d float32."""
    dev = tables[0].device
    chunk = idx[0].shape[-1]
    host_idx = [a.reshape(-1).cpu().numpy() for a in idx]
    dev_idx = [a.reshape(-1).to(dev, torch.int64) for a in idx]
    vals = [v.reshape(-1) for v in vals]
    keep = mask.reshape(-1).cpu().numpy() != 0
    mf = torch.from_numpy(keep.astype(np.float32)).to(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    total, acc = zero, zero
    for g in range(len(keep) // group):
        sl = slice(g * group, (g + 1) * group)
        rows = [T.index_select(0, ix[sl]) for T, ix in zip(tables, dev_idx)]
        new, terms = rows_fn(rows, [v[sl] for v in vals], mf[sl, None])
        for b in range(sl.start, sl.stop):
            if keep[b]:
                for T, ix, nr in zip(tables, host_idx, new):
                    T[int(ix[b])] = nr[b - sl.start]
        acc = acc + terms.sum()
        if sl.stop % chunk == 0:
            total, acc = total + acc, zero
    return total


def _n_state(table: torch.Tensor, optimizer: str) -> tuple[int, int]:
    """(n_state, Kp) of a fused table."""
    n = _N_STATE[optimizer]
    if table.dim() != 2 or table.shape[1] % (1 + n):
        raise ValueError(f"a fused {optimizer} table is [rows, "
                         f"{1 + n} * Kp], got {tuple(table.shape)}")
    Kp = table.shape[1] // (1 + n)
    if Kp % 4 or Kp > LANES:
        raise ValueError(f"segment width {Kp} is not a multiple of 4 in "
                         f"[4, {LANES}]")
    return n, Kp


def _same_layout(A, B, optimizer: str) -> tuple[int, int]:
    """(n_state, Kp) of two fused tables that must share it."""
    lay = _n_state(A, optimizer)
    if _n_state(B, optimizer) != lay:
        raise ValueError("both tables must have one fused layout")
    return lay


def _check_streams(streams, group: int) -> int:
    """Every stream has the first one's shape ``[S, 1, chunk]``; ``group``
    divides ``chunk``.  Returns chunk."""
    shape = tuple(streams[0].shape)
    if len(shape) != 3 or shape[1] != 1:
        raise ValueError(f"streams are [S, 1, chunk], got {shape}")
    if any(tuple(s.shape) != shape for s in streams):
        raise ValueError("every stream must have the same shape")
    chunk = shape[2]
    if group < 1 or chunk % group:
        raise ValueError(f"group {group} must divide chunk {chunk}")
    return chunk


def bpr_pallas_epoch_plain(W, H, u, i, j, mask, *, optimizer: str,
                           lr: float, wd: float, beta1: float = 0.9,
                           beta2: float = 0.999, eps: float = 1e-8,
                           group: int = 1):
    """Plain PyTorch version of :func:`bpr_pallas_epoch`
    (`pallas_engine.py:139-182`)."""
    n, Kp = _n_state(W, optimizer)

    def rows_fn(rows, vals, mf):
        (wu, st_u), (hi, st_i), (hj, st_j) = (_split(r, Kp, n) for r in rows)
        diff = hi - hj
        x = torch.sum(wu * diff, dim=1, keepdim=True)
        sig = 1.0 / (1.0 + torch.exp(x))               # sigma(-x)
        g_wu = -(sig * diff - wd * wu)
        g_hi = -(sig * wu - wd * hi)
        g_hj = -(-sig * wu - wd * hj)
        new = [_updated(p, s, g, optimizer, lr, beta1, beta2, eps)
               for p, s, g in ((wu, st_u, g_wu), (hi, st_i, g_hi),
                               (hj, st_j, g_hj))]
        l2 = (torch.sum(wu * wu, dim=1, keepdim=True)
              + torch.sum(hi * hi, dim=1, keepdim=True)
              + torch.sum(hj * hj, dim=1, keepdim=True))
        softplus = torch.clamp(-x, min=0.0) + torch.log1p(
            torch.exp(-torch.abs(x)))
        return new, mf * (softplus + wd * l2)

    loss = _run_plain([W, H, H], [u, i, j], [], mask, group, rows_fn)
    return W, H, loss


def relmf_pallas_epoch_plain(W, H, u, i, w, mask, *, optimizer: str,
                             lr: float, wd: float, beta1: float = 0.9,
                             beta2: float = 0.999, eps: float = 1e-8,
                             group: int = 1):
    """Plain PyTorch version of :func:`relmf_pallas_epoch`
    (`pallas_engine.py:270-306`)."""
    n, Kp = _n_state(W, optimizer)

    def rows_fn(rows, vals, mf):
        (wu, st_u), (hi, st_i) = (_split(r, Kp, n) for r in rows)
        wv = vals[0][:, None]
        s = torch.sum(wu * hi, dim=1, keepdim=True)
        coef = wv - s
        g_wu = -coef * hi + wd * wu
        g_hi = -coef * wu + wd * hi
        new = [_updated(wu, st_u, g_wu, optimizer, lr, beta1, beta2, eps),
               _updated(hi, st_i, g_hi, optimizer, lr, beta1, beta2, eps)]
        l2 = (torch.sum(wu * wu, dim=1, keepdim=True)
              + torch.sum(hi * hi, dim=1, keepdim=True))
        loss = (wv * torch.square(1.0 - s) + (1.0 - wv) * torch.square(s)
                + wd * l2)
        return new, mf * loss

    loss = _run_plain([W, H], [u, i], [w], mask, group, rows_fn)
    return W, H, loss


def glove_pallas_epoch_plain(Wc, Wx, c, x, f, logcnt, mask, *, lr: float,
                             k_dim: int, group: int = 1):
    """Plain PyTorch version of :func:`glove_pallas_epoch`
    (`pallas_engine.py:377-412`)."""
    _, Kp = _n_state(Wc, "adagrad")
    col = torch.arange(Kp, device=Wc.device)
    mask_c = (col != k_dim + 1).to(torch.float32)
    mask_x = (col != k_dim).to(torch.float32)

    def rows_fn(rows, vals, mf):
        (wc, (ac,)), (hx, (ax,)) = (_split(r, Kp, 1) for r in rows)
        fv, lc = vals[0][:, None], vals[1][:, None]
        diff = torch.sum(wc * hx, dim=1, keepdim=True) - lc
        fd = fv * diff
        new = [_updated(wc, [ac], fd * hx * mask_c, "adagrad", lr, 0, 0, 0),
               _updated(hx, [ax], fd * wc * mask_x, "adagrad", lr, 0, 0, 0)]
        return new, mf * 0.5 * fv * torch.square(diff)

    loss = _run_plain([Wc, Wx], [c, x], [f, logcnt], mask, group, rows_fn)
    return Wc, Wx, loss


# --------------------------------------------------------------- kernels --

def _launch(name, entry, tables, ints, floats, mask, chunk, group, tail,
            placement):
    """Checks what the kernel takes and launches ``entry``: the tables,
    their row counts, the int32 streams ``ints`` and float32 streams
    ``floats`` (flattened), the mask, ``n``, chunk, group, the placement
    (-1, the C plan's, unless ``placement`` forces one), then
    ``tail`` (the entry point's own ints and floats) and the loss."""
    dev = tables[0].device
    for k, t in enumerate(tables):
        _kernels.require(t, f"table {k}", torch.float32, dev, ndim=2)
    for k, s in enumerate(ints + [mask]):
        _kernels.require(s, f"index stream {k}", torch.int32, dev)
    for k, s in enumerate(floats):
        _kernels.require(s, f"value stream {k}", torch.float32, dev)
    lib = _kernels.lib()
    if group > lib.cymf_seq_epoch_max_group():
        raise ValueError(f"{name} takes group <= "
                         f"{lib.cymf_seq_epoch_max_group()}, got {group}")
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch(name, dev, *tables, *(t.shape[0] for t in tables),
                    *ints, *floats, mask, mask.numel(), chunk, group,
                    -1 if placement is None else int(placement), *tail, loss,
                    entry=entry)
    return loss


def _route(name, tables, placement=None):
    """``"plain"`` for tables on the CPU, ``"kernel"`` on the card.  A
    forced placement has no meaning for the plain version: it raises."""
    devs = {t.device for t in tables}
    if len(devs) != 1:
        raise ValueError(f"{name}: the tables are on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        if placement is not None:
            raise ValueError(f"{name}: _placement applies to the kernel; "
                             "tables on the CPU run the plain version")
        return "plain"
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return "kernel"


def _opt_floats(lr, wd, beta1, beta2, eps):
    # 1 - beta rounded once, as the JAX kernel's constants
    return [lr, wd, beta1, 1 - beta1, beta2, 1 - beta2, eps]


@torch.no_grad()
def bpr_pallas_epoch(W, H, u, i, j, mask, *, optimizer: str, lr: float,
                     wd: float, beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, group: int = 1, _placement=None):
    """One launch of sequential BPR updates on fused tables.

    Args:
      W, H: fused float32 tables (:func:`pack_table`), updated IN PLACE.
      u, i, j, mask: int32 ``[S, 1, chunk]`` streams (mask nonzero =
        keep); every index lies in its table, masked samples included.
      group: samples a step reads from one snapshot (must divide chunk):
        1 = the reference's exact schedule, 8 = its 8-thread analogue.

    Returns ``(W, H, loss_sum)``, the loss a 0-d float32 tensor.  Tables
    on the card launch ``csrc/seq_epoch.cu`` (and count the launch) at
    its plan's placement, or at ``_placement`` (0 or 1; tests
    only: a placement the kernel refuses raises ``RuntimeError``); on the
    CPU the plain version runs, and a ``_placement`` raises
    ``ValueError``."""
    chunk = _check_streams([u, i, j, mask], group)
    n, Kp = _same_layout(W, H, optimizer)
    kw = dict(optimizer=optimizer, lr=lr, wd=wd, beta1=beta1, beta2=beta2,
              eps=eps, group=group)
    if _route("bpr_pallas_epoch", [W, H], _placement) == "plain":
        return bpr_pallas_epoch_plain(W, H, u, i, j, mask, **kw)
    loss = _launch("bpr_pallas_epoch", "cymf_bpr_seq_epoch", [W, H],
                   [u, i, j], [], mask, chunk, group,
                   [Kp, n, *_opt_floats(lr, wd, beta1, beta2, eps)],
                   _placement)
    return W, H, loss


@torch.no_grad()
def relmf_pallas_epoch(W, H, u, i, w, mask, *, optimizer: str, lr: float,
                       wd: float, beta1: float = 0.9, beta2: float = 0.999,
                       eps: float = 1e-8, group: int = 1,
                       _placement=None):
    """One launch of sequential RelMF updates on fused tables: ``u, i``
    int32 ``[S, 1, chunk]`` sampled cells, ``w`` float32 label weights
    ``r / max(p_i, M)``, ``mask`` nonzero = keep (0 for padding).
    Otherwise as :func:`bpr_pallas_epoch`; launches count as
    ``relmf_pallas_epoch``."""
    chunk = _check_streams([u, i, w, mask], group)
    n, Kp = _same_layout(W, H, optimizer)
    kw = dict(optimizer=optimizer, lr=lr, wd=wd, beta1=beta1, beta2=beta2,
              eps=eps, group=group)
    if _route("relmf_pallas_epoch", [W, H], _placement) == "plain":
        return relmf_pallas_epoch_plain(W, H, u, i, w, mask, **kw)
    loss = _launch("relmf_pallas_epoch", "cymf_relmf_seq_epoch", [W, H],
                   [u, i], [w], mask, chunk, group,
                   [Kp, n, *_opt_floats(lr, wd, beta1, beta2, eps)],
                   _placement)
    return W, H, loss


@torch.no_grad()
def glove_pallas_epoch(Wc, Wx, c, x, f, logcnt, mask, *, lr: float,
                       k_dim: int, group: int = 1, _placement=None):
    """One launch of sequential fused-bias GloVe AdaGrad updates.  The
    tables are ``pack_table(augmented, "adagrad")`` of ``[w | b_c | 1]`` and
    ``[h | 1 | b_x]`` (width ``k_dim + 2``); their constant-one columns get
    no gradient and stay exactly one.  ``c, x`` int32 ``[S, 1, chunk]``,
    ``f, logcnt`` float32 sample weights and log counts, ``mask`` nonzero =
    keep.  Otherwise as :func:`bpr_pallas_epoch`; launches count as
    ``glove_pallas_epoch``."""
    chunk = _check_streams([c, x, f, logcnt, mask], group)
    _, Kp = _same_layout(Wc, Wx, "adagrad")
    if k_dim + 2 > Kp:
        raise ValueError(f"k_dim + 2 = {k_dim + 2} exceeds the segment "
                         f"width {Kp}")
    if _route("glove_pallas_epoch", [Wc, Wx], _placement) == "plain":
        return glove_pallas_epoch_plain(Wc, Wx, c, x, f, logcnt, mask, lr=lr,
                                        k_dim=k_dim, group=group)
    loss = _launch("glove_pallas_epoch", "cymf_glove_seq_epoch", [Wc, Wx],
                   [c, x], [f, logcnt], mask, chunk, group,
                   [Kp, int(k_dim), lr], _placement)
    return Wc, Wx, loss
