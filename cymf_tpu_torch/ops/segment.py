"""Index-space primitives for sparse row updates and CSR membership tests.

Port of `cymf_tpu/ops/segment.py`:

* :func:`dedup_rows` turns a batch of (row, grad) pairs with duplicates
  into "one summed gradient per unique row", so a synchronous row update
  is race-free and exact (the reference's per-sample Hogwild updates,
  `cymf/optimizer.pyx:52-58`);
* :func:`csr_contains` / :func:`csr_lookup` read cells of a CSR matrix at
  arbitrary (row, column) queries without densifying it.  The JAX package
  runs a 32-round vectorized binary search inside each row's segment; here
  one ``torch.searchsorted`` over the entries' int64 keys
  ``row * 2**31 + col`` finds the same position, since a CSR matrix with
  sorted indices has its keys sorted globally.

Every function keeps its output shapes fixed by its inputs' and makes no
host sync.
"""

from __future__ import annotations

import torch

_KEY_SHIFT = 31  # columns are int32: row * 2**31 + col never collides


def scatter_add_rows(buf: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """``buf[rows[p]] += vals[p]`` for every ``p``, IN PLACE (``rows``
    in range, duplicates allowed); returns ``buf``.  In float32 one
    ``index_add_``.  In a reduced dtype (a bfloat16 param dtype) the
    duplicates of a row are added one by one in ``p`` order, each add
    rounded, as XLA's scatter-add of that dtype adds them
    (``index_put_(accumulate=True)``; ``index_add_`` accumulates them
    otherwise on the CPU)."""
    if buf.dtype in (torch.bfloat16, torch.float16):
        return buf.index_put_((rows.long(),), vals, accumulate=True)
    return buf.index_add_(0, rows, vals)


def dedup_rows(rows: torch.Tensor, grads: torch.Tensor, drop_index: int,
               presorted: bool = False):
    """Combine duplicate row indices by summing their gradients.

    ``rows`` is int ``[B]`` (duplicates allowed), ``grads`` ``[B, ...]``
    aligned with it.  Returns ``(unique_rows, summed_grads)``, both length
    ``B``, in the stably sorted order of ``rows``: the first occurrence of
    each distinct row carries it and the sum of its gradients, every other
    occurrence carries ``drop_index`` and zeros.  ``presorted``: ``rows``
    is already sorted (the sort is skipped).
    """
    b = rows.shape[0]
    if presorted:
        srows, sgrads = rows, grads
    else:
        srows, order = torch.sort(rows, stable=True)
        sgrads = grads.index_select(0, order)
    is_start = torch.ones(b, dtype=torch.bool, device=rows.device)
    is_start[1:] = srows[1:] != srows[:-1]
    seg_id = torch.cumsum(is_start, 0) - 1
    sums = scatter_add_rows(torch.zeros_like(sgrads), seg_id, sgrads)
    out_rows = torch.where(is_start, srows,
                           torch.full_like(srows, drop_index))
    gshape = (b,) + (1,) * (grads.dim() - 1)
    out_grads = torch.where(is_start.view(gshape),
                            sums.index_select(0, seg_id),
                            torch.zeros_like(sgrads))
    return out_rows, out_grads


def _entry_keys(indptr: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """int64 ``row * 2**31 + col`` of every stored entry, in CSR order."""
    n_rows = indptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=indices.device), indptr.diff(),
        output_size=indices.shape[0])
    return (rows << _KEY_SHIFT) + indices.to(torch.int64)


def _find(indptr, indices, seg, query):
    """``(found, pos)``: whether the cell ``(seg[b], query[b])`` is stored,
    and the position of its entry (clamped into range where it is not)."""
    keys = _entry_keys(indptr, indices)
    q = (seg.to(torch.int64) << _KEY_SHIFT) + query.to(torch.int64)
    pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    return keys.index_select(0, pos) == q, pos


def csr_contains(indptr: torch.Tensor, indices: torch.Tensor,
                 seg: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """bool ``[B]``: is ``query[b]`` among
    ``indices[indptr[seg[b]]:indptr[seg[b]+1]]``?  ``indices`` sorted
    within each row (scipy's ``sort_indices()``)."""
    if indices.shape[0] == 0:  # empty matrix: nothing is a member
        return torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    return _find(indptr, indices, seg, query)[0]


def csr_lookup(indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, seg: torch.Tensor, query: torch.Tensor):
    """``(found bool[B], value[B])``: the CSR value at ``(seg, query)``, 0
    where the cell is not stored (RelMF's labels of a non-binary ``X``,
    `cymf/relmf.pyx:148`)."""
    if indices.shape[0] == 0:
        return (torch.zeros(seg.shape, dtype=torch.bool, device=seg.device),
                torch.zeros(seg.shape, dtype=data.dtype, device=seg.device))
    found, pos = _find(indptr, indices, seg, query)
    value = torch.where(found, data.index_select(0, pos),
                        torch.zeros((), dtype=data.dtype, device=data.device))
    return found, value
