"""Exact (user, item)-pair membership via a bucketized two-level hash set.

Port of `cymf_tpu/ops/hashset.py`: the host builder is the same numpy
code, so the tables are identical, and :func:`hashset_contains` answers
with two row-gathers on the device.  The 32-bit mixing runs in int64
with ``& 0xFFFFFFFF`` (PyTorch's uint32 arithmetic is thin); every
product is split so that no intermediate leaves int64's range.

Layout: two levels of bucketized int32 tables of shape
``(num_buckets, 2 * SLOTS)``; slots ``[:, :SLOTS]`` hold user ids,
``[:, SLOTS:]`` item ids, empty slots -1.  Pairs that overflow level 1
go to level 2; the builder grows level 2 until nothing overflows, so
queries are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import upload

_SLOTS1 = 64   # level-1 bucket width
_SLOTS2 = 16   # level-2: small overflow table
_SALT1 = np.uint32(0x9E3779B1)
_SALT2 = np.uint32(0x7FEB352D)
_M32 = 0xFFFFFFFF


def _mix_np(u: np.ndarray, i: np.ndarray, salt: np.uint32) -> np.ndarray:
    """32-bit mixing of a pair (murmur3-style finalizer). Must stay in sync
    with :func:`_mix_torch`."""
    x = (u.astype(np.uint32) * np.uint32(0x85EBCA6B)
         + i.astype(np.uint32) * np.uint32(0xC2B2AE35) + salt)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x



def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the high half
    of ``c`` only reaches the low 32 bits through its low 16 product bits,
    so every intermediate stays below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix_torch(u: torch.Tensor, i: torch.Tensor, salt: int) -> torch.Tensor:
    x = (_mul32(u & _M32, 0x85EBCA6B) + _mul32(i & _M32, 0xC2B2AE35)
         + int(salt)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class PairHashSet(NamedTuple):
    table1: np.ndarray | torch.Tensor  # int32[NB1, 2 * _SLOTS1]
    table2: np.ndarray | torch.Tensor  # int32[NB2, 2 * _SLOTS2]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _place(users: np.ndarray, items: np.ndarray, num_buckets: int,
           salt: np.uint32, slots: int):
    """Pack pairs into ``slots``-way buckets; returns (table, overflow)."""
    b = (_mix_np(users, items, salt) & np.uint32(num_buckets - 1)).astype(
        np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    # rank within each equal-bucket run
    if len(bs) > 1:
        new_run = np.r_[True, bs[1:] != bs[:-1]]
    else:
        new_run = np.ones(len(bs), dtype=bool)
    run_ids = np.cumsum(new_run) - 1
    first_pos = np.flatnonzero(new_run)
    rank = np.arange(len(bs)) - first_pos[run_ids]
    fits = rank < slots

    table = np.full((num_buckets, 2 * slots), -1, dtype=np.int32)
    sel = order[fits]
    table[bs[fits], rank[fits]] = users[sel]
    table[bs[fits], slots + rank[fits]] = items[sel]
    overflow = np.zeros(len(users), dtype=bool)
    overflow[order[~fits]] = True
    return table, overflow


def build_pair_hashset(users: np.ndarray, items: np.ndarray) -> PairHashSet:
    """Build from interaction arrays (duplicates deduplicated first).
    Returns numpy tables; :func:`to_device` moves them."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    key = users * (items.max(initial=0) + 1) + items
    _, uniq_idx = np.unique(key, return_index=True)
    users = users[uniq_idx].astype(np.int32)
    items = items[uniq_idx].astype(np.int32)
    nnz = len(users)

    # level-1 load ~32/64: overflow is rare and goes to the small level 2
    nb1 = _next_pow2(max(nnz // 32, 1))
    table1, of = _place(users, items, nb1, _SALT1, _SLOTS1)
    u2, i2 = users[of], items[of]
    nb2 = _next_pow2(max(len(u2) // 4, 1))
    for _ in range(8):
        table2, of2 = _place(u2, i2, nb2, _SALT2, _SLOTS2)
        if not of2.any():
            break
        nb2 *= 2
    else:
        raise RuntimeError("hash set build failed to converge")
    return PairHashSet(table1, table2)



def to_device(hs: PairHashSet, device) -> PairHashSet:
    """The set's tables as int32 tensors on ``device`` (``h2d_bytes``)."""
    return PairHashSet(*(upload(torch.as_tensor(t, dtype=torch.int32),
                                device) for t in hs))


def hashset_contains(hs: PairHashSet, u: torch.Tensor,
                     i: torch.Tensor) -> torch.Tensor:
    """bool[B]: is the pair (u[b], i[b]) in the set?  ``hs`` holds tensors
    on the queries' device (:func:`to_device`).  Two row-gathers."""
    u64 = u.to(torch.int64)
    i64 = i.to(torch.int64)

    def level(table, salt):
        nb = table.shape[0]
        slots = table.shape[1] // 2
        b = _mix_torch(u64, i64, int(salt)) & (nb - 1)
        row = table.index_select(0, b)                   # (B, 2*slots)
        return torch.any((row[:, :slots] == u64[:, None])
                         & (row[:, slots:] == i64[:, None]), dim=1)

    return level(hs.table1, _SALT1) | level(hs.table2, _SALT2)
