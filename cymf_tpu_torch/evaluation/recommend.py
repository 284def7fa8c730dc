"""Full-catalog top-k recommender.  Port of
`cymf_tpu/evaluation/recommend.py`.

Per chunk of users: one ``(users_chunk x K) @ (K x items)`` product in
full float32, the user's excluded (train) items set to ``-inf``, and a
top-k whose ties go to the lower item id, as ``jax.lax.top_k``'s do.
``torch.topk`` promises no order among equal scores, so the winners are
re-ranked by (score descending, id ascending), and a row whose k-th score
is shared by an item that ``torch.topk`` left out (a user whose exclusions
leave fewer than k finite scores, integer-valued factors) is ranked again
over its whole row by the same key.

The exclusion CSR is uploaded once a call and each chunk's ``(row, col)``
pairs are cut from it on the device.  (The JAX form pads each chunk's
exclusions on the host to a power of two, which bounds XLA's compiled
shapes; eager PyTorch has no compiled shapes to bound.)

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) the
catalog is row-sharded, as the JAX package's ``_topk_sharded``: each rank
scores its item shard ``(C, K) @ (K, I/n)`` (pad rows and excluded items at
``-inf``), takes a local top-k by the same rule, and the ranks'
``(C, k)`` candidates are all-gathered and merged by (score descending, id
ascending), so the items equal the single-device ones, ties included.
Every rank gets the whole result.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import sparse

from .. import config
from ..parallel.mesh import current_mesh
from ..utils.profiling import span, spanned, upload

_LOW32 = (1 << 32) - 1


def _stable_topk(scores: torch.Tensor, k: int, ids: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of each row of ``scores`` (float32 ``[C, L]``) by
    (score descending, id ascending): ``(values, ids)``, ``[C, k]``.
    ``ids`` (int64 ``[C, L]``) names each column's item; by default its
    column index.  Each score and id become one int64 key, the float's
    bits mapped to an order-preserving integer (``-0.0`` taken as ``0.0``)
    above the complement of the id, so the keys are distinct and one
    ``torch.topk`` over them is exact."""
    bits = (scores + 0.0).view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    if ids is None:
        ids = torch.arange(scores.shape[1], device=scores.device)
    pos = torch.topk(key * (1 << 32) + (_LOW32 - ids), k).indices
    return scores.gather(1, pos), ids.expand_as(scores).gather(1, pos)


def _topk_chunk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of ``scores`` with ties by ascending id."""
    vals, idx = torch.topk(scores, min(k + 1, scores.shape[1]))
    # an item outside the top k shares the k-th score: the (k+1)-th
    # largest score equals the k-th
    short = vals[:, k] == vals[:, k - 1] if vals.shape[1] > k \
        else torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
    vals, idx = _stable_topk(vals[:, :k].contiguous(), k,
                             idx[:, :k].contiguous())
    rows = torch.nonzero(short)[:, 0]
    if rows.numel():
        vals[rows], idx[rows] = _stable_topk(scores.index_select(0, rows), k)
    return vals, idx


@torch.no_grad()
@spanned("recommend")
def recommend(W, H, k: int = 10, exclude=None, user_chunk: int = 4096,
              device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k items per user over the full catalog.

    Args:
      W: [U, K] user factors (numpy array or tensor).
      H: [I, K] item factors.
      k: items to return per user.
      exclude: optional scipy sparse matrix of already-seen (train)
        interactions to exclude from recommendations.
      user_chunk: users scored per product.
      device: where to score; by default
        :func:`cymf_tpu_torch.config.default_device`, the card; under a
        mesh of more than one rank, the rank's device (another raises
        ``ValueError``).

    Returns:
      (scores float32[U, k], items int32[U, k]) sorted by score descending,
      equal scores by ascending item id.  ``W`` and ``H`` are first cast
      to :func:`cymf_tpu_torch.config.param_dtype` (under bfloat16, ties
      are common), then scored in float32.  Under a mesh, a collective: every
      rank calls it with the same arguments and gets the whole result.

    A call is a span ``recommend`` (:mod:`cymf_tpu_torch.utils.profiling`):
    ``recommend.upload`` (the tables), ``recommend.exclusions`` (the CSR and
    its upload) and one ``recommend.fetch`` a chunk (its answer to the
    host, which waits for the card).
    """
    mesh = current_mesh()
    n = mesh.num_devices
    dev = mesh.resolve_device(device)
    dtype = config.param_dtype()
    Ht = torch.as_tensor(H, dtype=dtype)
    I = Ht.shape[0]
    if k > I:
        raise ValueError(f"k={k} exceeds catalog size {I}")
    # this rank's item rows [lo, lo + ipd) of the catalog padded to n
    ipd = mesh.pad_rows(I) // n
    lo = mesh.rank * ipd
    with span("recommend.upload"):
        Wd = upload(torch.as_tensor(W, dtype=dtype), dev)
        # float32 scores under any param dtype, as the JAX package's
        # preferred_element_type: the tables' values cast, their products
        # exact
        Hd = upload(Ht[lo:lo + ipd], dev).float()
    U = Wd.shape[0]

    if exclude is not None:
        with span("recommend.exclusions"):
            X = sparse.csr_matrix(exclude)
            indptr = X.indptr.astype(np.int64)
            indptr_d = upload(torch.from_numpy(indptr), dev)
            # scipy's own index dtype: no host copy, widened a chunk at a
            # time
            indices_d = upload(torch.from_numpy(X.indices), dev)

    out_scores = np.empty((U, k), np.float32)
    out_items = np.empty((U, k), np.int32)
    for start in range(0, U, user_chunk):
        end = min(start + user_chunk, U)
        scores = Wd[start:end].float() @ Hd.T
        if scores.shape[1] < ipd:  # the last shard's pad rows
            scores = torch.nn.functional.pad(
                scores, (0, ipd - scores.shape[1]), value=-torch.inf)
        if exclude is not None:
            a, b = int(indptr[start]), int(indptr[end])
            rows = torch.repeat_interleave(
                torch.arange(end - start, device=dev),
                indptr_d[start + 1:end + 1] - indptr_d[start:end],
                output_size=b - a)
            cols = indices_d[a:b].long()
            if n > 1:  # this shard's columns of the exclusions
                cols = cols - lo
                mine = (cols >= 0) & (cols < ipd)
                rows, cols = rows[mine], cols[mine]
            scores.index_put_((rows, cols),
                              upload(torch.tensor(-torch.inf), dev))
        vals, idx = _topk_chunk(scores, min(int(k), ipd))
        if n > 1:
            # merge the ranks' candidates by (score desc, global id asc)
            vals, idx = _stable_topk(
                mesh.all_gather(vals.T.contiguous()).T.contiguous(), int(k),
                mesh.all_gather((idx + lo).T.contiguous()).T.contiguous())
        with span("recommend.fetch"):
            out_scores[start:end] = vals.cpu().numpy()
            out_items[start:end] = idx.to(torch.int32).cpu().numpy()
    return out_scores, out_items
