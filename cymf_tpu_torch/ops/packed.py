"""Packed embedding-table layout: several logical rows per 128-lane row.

The layout of `cymf_tpu/ops/packed.py`, kept as it is so that the port's
tables, host prep and kernels line up with the JAX package element for
element.  Logical row ``r`` lives in physical row ``r // s``, lanes
``[(r % s) * K, (r % s) * K + K)``; one lane per slot past the payload
(lanes ``[s*K, s*K + s)``) is the *count channel* that carries per-row
live-sample counts through the accumulation.  On the H100 the packing
also keeps each gathered row one 512-byte line, so the sample kernel
reads it with one ``float4`` per lane.

The host-side helpers are numpy; :func:`split_counts` and
:func:`expand_counts` act on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128


def num_slots(K: int) -> int:
    """Logical rows per physical row: ``s * (K + 1) <= 128`` leaves one
    count lane per slot.  K > 127 is unsupported (:func:`packable`)."""
    return max(1, LANES // (int(K) + 1))


def packable(K: int) -> bool:
    """True if the packed engine supports this dimension."""
    return int(K) <= LANES - 1


def count_base(K: int) -> int:
    """First lane of the count channel."""
    return num_slots(K) * int(K)


def packed_rows(n_rows: int, K: int, multiple: int = 8) -> int:
    """Physical row count for ``n_rows`` logical rows, padded up to
    ``multiple``."""
    s = num_slots(K)
    r = -(-n_rows // s)
    return -(-r // multiple) * multiple


def logical_rows(n_rows: int, multiple: int = 8) -> int:
    """Row count of a LOGICAL-layout table (one row per 128-lane row,
    payload in lanes ``[0, K)``), padded to ``multiple``."""
    return -(-int(n_rows) // multiple) * multiple


def pack_logical(table, K: int | None = None, multiple: int = 8):
    """Host-side: (N, K) -> (R, 128) LOGICAL-layout ndarray, payload in
    lanes ``[0, K)`` and every other lane zero (the item table: its rows
    arrive lane-aligned in the sample kernel, and the accumulated count
    lands in lane ``K``)."""
    table = np.asarray(table, np.float32)
    N, K_ = table.shape
    K = K_ if K is None else K
    R = logical_rows(N, multiple)
    out = np.zeros((R, LANES), np.float32)
    out[:N, :K] = table
    return out


def pack_array(table, K: int | None = None, multiple: int = 8):
    """Host-side: (N, K) -> (R, 128) packed ndarray (float32)."""
    table = np.asarray(table, np.float32)
    N, K_ = table.shape
    K = K_ if K is None else K
    s = num_slots(K)
    R = packed_rows(N, K, multiple)
    out = np.zeros((R, LANES), np.float32)
    flat = np.zeros((R * s, K), np.float32)
    flat[:N] = table
    out[:, : s * K] = flat.reshape(R, s * K)
    return out


def unpack_array(packed, N: int, K: int):
    """Host-side inverse of :func:`pack_array` -> (N, K) ndarray."""
    packed = np.asarray(packed)
    R = packed.shape[0]
    s = num_slots(K)
    flat = packed[:, : s * K].reshape(R * s, K)
    return np.array(flat[:N], np.float32)


def split_counts(acc: torch.Tensor, K: int):
    """[R, 128] accumulation buffer -> (payload [R, cbase], counts [R, s])
    views."""
    cbase = count_base(K)
    s = num_slots(K)
    return acc[:, :cbase], acc[:, cbase:cbase + s]


def expand_counts(cnt: torch.Tensor, K: int) -> torch.Tensor:
    """[R, s] per-logical-row counts -> [R, s*K] per-payload-lane."""
    return torch.repeat_interleave(cnt, int(K), dim=1)
