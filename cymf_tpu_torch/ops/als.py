"""Batched ALS solve primitives shared by WMF and ExpoMF.  Port of
`cymf_tpu/ops/als.py`.

The reference solves one K x K system per row in an OpenMP loop with
LAPACK ``dgesv`` (`cymf/wmf.pyx:150-174`).  Here rows are batched:

* the shared Gramian ``Y^T Y`` is one K x K product;
* each row's rank-``deg`` correction comes from a padded gather of its
  positives, ``A_c = A0 + (c-1) sub^T sub``, as one batched product;
* the systems are solved by batched Cholesky (SPD for ``weight >= 1``,
  ``weight_decay > 0``), with an LU option mirroring the reference's
  ``dgesv``.

Rows are grouped on the host into degree-bucketed chunks
(:func:`build_chunks`, identical to the JAX package's), so the padded
gather stays tight at ML-20M scale.

Every product runs in float32 at PyTorch's global matmul precision, also
under a bfloat16 param dtype (``config.set_param_dtype``): where the JAX
package multiplies bfloat16 operands with ``preferred_element_type=
float32`` (the Gramians, the corrections, the exposure), the port casts
them to float32 first and multiplies there (a product of two bfloat16
values is exact in float32, so only the summation order differs), and the
solves promote a bfloat16 right-hand side to float32.  The sums the JAX
package leaves in the param dtype stay there: ``b = weight * sum(sub)``.
A solution is cast to the target table's dtype where it is written.  The
JAX package runs the products at ``Precision.HIGHEST``, so TF32 must stay
off:
``torch.backends.cuda.matmul.allow_tf32`` False and
``torch.get_float32_matmul_precision() == "highest"``, PyTorch's defaults.
No solve here syncs with the host: a failed factorisation gives NaN, as in
XLA.
"""

from __future__ import annotations

import functools
import os
from typing import List, NamedTuple

import numpy as np
import torch
from scipy import sparse

from ..config import scalar
from ..utils.profiling import count, span, upload
from .chol_kernel import (MAX_BLOCK, chol_inv_batched,
                          chol_inv_batched_plain, cholesky_nan)


def solve_spd_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve, ``A [..., K, K]``, ``b [..., K]``:
    ``cholesky_ex`` + ``cholesky_solve``.  The counterpart of the JAX
    package's ``solve_spd_xla``; its solver name stays ``cholesky_xla``,
    the form that ``CYMF_TPU_ALS_CHOL=xla`` selects.  ``b`` is promoted to
    ``A``'s dtype."""
    return torch.cholesky_solve(b[..., None].to(A.dtype),
                                cholesky_nan(A))[..., 0]


def solve_spd_blocked(A: torch.Tensor, b: torch.Tensor, block: int = 64,
                      diag: str = "plain") -> torch.Tensor:
    """Batched SPD solve by the blocked left-looking Cholesky: small
    diagonal-block factorisations, their explicit inverses, and batched
    products for the panels and both substitution sweeps.  ``diag`` names
    the diagonal factor: ``"kernel"`` is :func:`chol_inv_batched` (the CUDA
    kernel on a CUDA tensor), ``"plain"`` its plain version.  The same
    solution as :func:`solve_spd_dense` up to float32 round-off.  Falls
    back to the dense form when ``K`` is not divisible by and larger than
    ``block``, e.g. the small P x P Woodbury capacitance solves."""
    K = A.shape[-1]
    if K > block and K % block == 0:
        return _solve_spd_blocked(A, b, block, diag)
    return solve_spd_dense(A, b)


def resolve_chol_solver(solver: str, num_components: int,
                        device: torch.device) -> str:
    """Resolve ``"cholesky"`` to an explicit form, ``cholesky_xla``,
    ``cholesky_blocked<block>`` or ``cholesky_cuda<block>``, from
    ``CYMF_TPU_ALS_CHOL`` (auto|xla|blocked|pallas) and
    ``CYMF_TPU_ALS_CHOL_BLOCK`` (default 64), the JAX package's variables
    with the same validation.

    ``auto`` takes a blocked form at ``K >= 128``: the kernel form
    ``cholesky_cuda<block>`` when ``device`` is CUDA, the plain blocked
    form on the CPU (the JAX package's "pallas on TPU backends").
    ``pallas`` forces the kernel form, ``blocked`` the plain one.  When no
    blocked form can engage (``K`` not divisible by and larger than the
    block) the dense name is returned, so policy keyed on the solver (the
    WMF Woodbury cap) follows the one that runs.  The kernel form raises
    ``ValueError`` for a block above :data:`MAX_BLOCK`.  Trainers call this
    once per fit.
    """
    if solver != "cholesky":
        return solver
    mode = os.environ.get("CYMF_TPU_ALS_CHOL", "auto")
    if mode not in ("auto", "xla", "blocked", "pallas"):
        raise ValueError("CYMF_TPU_ALS_CHOL must be auto|xla|blocked|pallas")
    if mode != "xla" and num_components >= (0 if mode != "auto" else 128):
        block = int(os.environ.get("CYMF_TPU_ALS_CHOL_BLOCK", "64"))
        if num_components > block and num_components % block == 0:
            if mode == "auto":
                kind = "cuda" if torch.device(device).type == "cuda" \
                    else "blocked"
            else:
                kind = "cuda" if mode == "pallas" else "blocked"
            if kind == "cuda" and block > MAX_BLOCK:
                raise ValueError(
                    f"CYMF_TPU_ALS_CHOL_BLOCK={block}: the CUDA diagonal "
                    f"kernel takes blocks of at most {MAX_BLOCK}")
            return f"cholesky_{kind}{block}"
    return "cholesky_xla"


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve routed by matrix size, as
    :func:`resolve_chol_solver` routes ``"cholesky"`` for ``A``'s width
    and device.  For eager use; the trainers resolve the name once per
    fit instead."""
    return get_solver(resolve_chol_solver("cholesky", A.shape[-1],
                                          A.device))(A, b)


def get_solver(name: str):
    """Solver name -> callable, including ``cholesky_blocked<block>`` and
    ``cholesky_cuda<block>``."""
    for kind, diag in (("cholesky_blocked", "plain"),
                       ("cholesky_cuda", "kernel")):
        if name.startswith(kind):
            suffix = name[len(kind):]
            block = int(suffix) if suffix else 64
            return functools.partial(solve_spd_blocked, block=block,
                                     diag=diag)
    return _SOLVERS[name]


def _solve_spd_blocked(A: torch.Tensor, b: torch.Tensor, block: int,
                       diag: str = "plain") -> torch.Tensor:
    """Blocked left-looking Cholesky solve (see :func:`solve_spd_blocked`).

    The matrix is cut into ``nb = K / block`` block rows.  Per block
    column j the diagonal block, less its left updates, is factorised and
    inverted (``Dinv[j] = L[j][j]^{-1}``), so panel formation and both
    substitution sweeps are batched products.  The first diagonal block is
    a strided view of ``A``, which the CUDA kernel reads in place.

    Left behind: the JAX package sends diagonal batches of ``C < 256`` to
    XLA (`als.py:168-173`), a Mosaic small-tile workaround; here the kernel
    form launches the kernel for every ``C``.
    """
    K = A.shape[-1]
    nb = K // block
    lead = A.shape[:-2]
    A2 = A.reshape((-1, K, K))
    b2 = b.reshape((-1, K)).to(A.dtype)

    def dblk(M, i, j):
        return M[:, i * block:(i + 1) * block, j * block:(j + 1) * block]

    diag_factor = (functools.partial(chol_inv_batched, block=block)
                   if diag == "kernel" else chol_inv_batched_plain)

    with span("als.blocked"):
        L = [[None] * nb for _ in range(nb)]
        Dinv = [None] * nb
        for j in range(nb):
            Ajj = dblk(A2, j, j)
            for k in range(j):
                Ajj = Ajj - L[j][k] @ L[j][k].mT
            L[j][j], Dinv[j] = diag_factor(Ajj)
            for i in range(j + 1, nb):
                Aij = dblk(A2, i, j)
                for k in range(j):
                    Aij = Aij - L[i][k] @ L[j][k].mT
                L[i][j] = Aij @ Dinv[j].mT            # Aij Ljj^{-T}
        # forward: y_j = Ljj^{-1} (b_j - sum_{k<j} L[j][k] y_k)
        y = [None] * nb
        for j in range(nb):
            r = b2[:, j * block:(j + 1) * block, None]
            for k in range(j):
                r = r - L[j][k] @ y[k]
            y[j] = Dinv[j] @ r
        # backward: x_j = Ljj^{-T} (y_j - sum_{k>j} L[k][j]^T x_k)
        x = [None] * nb
        for j in range(nb - 1, -1, -1):
            r = y[j]
            for k in range(j + 1, nb):
                r = r - L[k][j].mT @ x[k]
            x[j] = Dinv[j].mT @ r
        return torch.cat(x, dim=1)[..., 0].reshape(lead + (K,))


def solve_lu(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched LU solve (the reference's ``dgesv``); ``solve_ex`` does not
    sync with the host to raise on a singular matrix.  ``b`` is promoted
    to ``A``'s dtype."""
    return torch.linalg.solve_ex(A, b[..., None].to(A.dtype))[0][..., 0]


# the bare "cholesky" name is the dense form: auto routing happens once
# per fit, in resolve_chol_solver
_SOLVERS = {"cholesky": solve_spd_dense, "cholesky_xla": solve_spd_dense,
            "lu": solve_lu}


class AlsChunk(NamedTuple):
    """One degree-bucketed chunk of rows to solve together."""
    rows: np.ndarray      # int32[C] target row ids (sentinel = drop)
    idx_pad: np.ndarray   # int32[C, P] padded positive indices into Y
    valid: np.ndarray     # bool[C, P]
    weights: np.ndarray   # float32[C, P] per-entry confidence weights (X data)


def build_chunks(X: sparse.csr_matrix, chunk_size: int, drop_sentinel: int,
                 max_elems: int = 1 << 25,
                 num_components: int = 0) -> List[AlsChunk]:
    """Degree-bucketed chunking of CSR rows, the JAX package's verbatim.

    Rows are sorted by degree ascending; each chunk is padded to the next
    power of two >= its max degree.  The number of rows per chunk shrinks
    for high-degree buckets so the padded gather stays under ``max_elems``
    index entries, and is rounded down to a power of two.  Partial chunks
    are padded with sentinel rows (dropped at scatter time).

    ``num_components``: when given, the cap is also scaled so the gathered
    ``(C, P, K)`` f32 buffer stays under ~2 GB.
    """
    if num_components > 0:
        max_elems = min(max_elems, max((1 << 29) // num_components, 1 << 16))
    n = X.shape[0]
    deg = np.diff(X.indptr)
    order = np.argsort(deg, kind="stable").astype(np.int64)
    chunks: List[AlsChunk] = []
    start = 0
    while start < n:
        # the pad length is set by the chunk's max (= last taken) degree;
        # scan forward while the (rows x pad) footprint stays in budget
        take = 1
        while take < chunk_size and start + take < n:
            pmax = int(deg[order[start + take]])
            P = 1
            while P < max(pmax, 1):
                P *= 2
            if (take + 1) * P > max_elems:
                break
            take += 1
        p2 = 1
        while p2 * 2 <= take:
            p2 *= 2
        take = p2
        sel = order[start:start + take]
        start += take
        c = len(sel)
        pmax = int(deg[sel].max()) if c else 0
        P = 1
        while P < max(pmax, 1):
            P *= 2
        idx_pad = np.zeros((c, P), dtype=np.int32)
        valid = np.zeros((c, P), dtype=bool)
        weights = np.zeros((c, P), dtype=np.float32)
        rows = np.full(c, drop_sentinel, dtype=np.int32)
        rows[:c] = sel
        for k, r in enumerate(sel):
            lo, hi = X.indptr[r], X.indptr[r + 1]
            d = hi - lo
            idx_pad[k, :d] = X.indices[lo:hi]
            valid[k, :d] = True
            weights[k, :d] = X.data[lo:hi]
        chunks.append(AlsChunk(rows, idx_pad, valid, weights))
    return chunks


def place_device_chunks(chunks: List[AlsChunk], device,
                        num_rows: int) -> List[AlsChunk]:
    """The chunks on one device: ``rows`` int64, ``idx_pad`` int32,
    ``valid`` bool.  Sentinel rows (``rows >= num_rows``) are dropped here,
    with their pads, where the JAX package drops them at the scatter
    (``mode="drop"``): ``T.index_copy_(0, rows, x)`` then writes every row
    it is given, and no mask has to reach the host.  ``weights`` stays on
    the host: no solve reads it."""
    out = []
    for c in chunks:
        keep = c.rows < num_rows
        if not keep.all():
            c = AlsChunk(*(a[keep] for a in c))
        out.append(AlsChunk(
            upload(torch.from_numpy(c.rows.astype(np.int64)), device),
            upload(torch.from_numpy(c.idx_pad), device),
            upload(torch.from_numpy(c.valid), device), c.weights))
    return out


# elements of a block of the packed operand and its doubled rows, formed at
# once in the weighted Gramian (1 GiB)
_GRAM_ELEMS = 1 << 28


@functools.lru_cache(maxsize=64)
def _packed_pairs(K: int, device: torch.device):
    """The packed operand's layout for width ``K``: ``(D, h, Kp, cols)``.

    Each unordered pair ``{p, q}`` of ``range(K)`` has one column.  Column
    ``d K + p``, for ``d < D = (K + 1) // 2``, holds ``y_p y_{(p+d) mod K}``;
    for even ``K`` a half group of ``h = K / 2`` columns follows (else
    ``h = 0``), column ``D K + p`` holding ``y_p y_{p+h}``.  That is
    ``D K + h = K (K + 1) / 2`` columns, each pair once, padded with zero
    columns to ``Kp``, a multiple of 32 (rows 128-byte aligned).  The
    cyclic order makes the ``D`` full groups one broadcast product of a
    strided view, with no gather.  ``cols [K*K]`` (int64, made on
    ``device``) maps ``p K + q`` to the column of ``{p, q}``."""
    D, h = (K + 1) // 2, K // 2 if K % 2 == 0 else 0
    cols = torch.empty((K, K), dtype=torch.int64, device=device)
    p = torch.arange(K, device=device)
    for d in range(D):
        cols[p, (p + d) % K] = cols[(p + d) % K, p] = d * K + p
    cols[p[:h], p[:h] + h] = cols[p[:h] + h, p[:h]] = D * K + p[:h]
    return D, h, -(-(D * K + h) // 32) * 32, cols.view(-1)


def weighted_gramian(E: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``sum_i E[c, i] y_i y_i^T`` for every row c of ``E (C, I)``:
    ``(C, K, K)``, in float32 (``Y`` in the param dtype is cast to
    float32 a block at a time).

    Each distinct product ``y_p y_q`` (``p <= q``) is formed and summed
    once: ``E @ P`` over row blocks of ``Y``, where ``P [I, Kp]`` is the
    packed operand of :func:`_packed_pairs` (``K (K + 1) / 2`` columns,
    zero-padded to ``Kp``), a block formed by one broadcast product and
    taken into the sum by one ``addmm``; the ``[C, Kp]`` sum is unpacked
    into the symmetric ``[C, K, K]`` by one ``index_select``, so the
    result is exactly symmetric.  No ``(C, I, K)`` tensor exists, and a
    block and its doubled rows hold at most ``_GRAM_ELEMS`` elements.
    Counts ``gramian_flops``, the ``2 C I Kp`` operations of the products.
    """
    I, K = Y.shape
    C = E.shape[0]
    D, h, Kp, cols = _packed_pairs(K, Y.device)
    count("gramian_flops", 2 * C * I * Kp)
    out = torch.zeros((C, Kp), dtype=torch.float32, device=Y.device)
    E = E.float()
    step = max(1, _GRAM_ELEMS // (Kp + 2 * K))
    P = torch.empty((min(step, I), Kp), dtype=torch.float32, device=Y.device)
    P[:, D * K + h:].zero_()
    for s in range(0, I, step):
        Yb = Y[s:s + step].float()
        n = len(Yb)
        # Y2[i, d + p] = y_i[(p + d) mod K] for d + p < 2K
        Y2 = torch.cat((Yb, Yb), 1)
        torch.mul(Yb[:, None, :], Y2.as_strided((n, D, K), (2 * K, 1, 1)),
                  out=P[:n, :D * K].view(n, D, K))
        torch.mul(Yb[:, :h], Yb[:, K - h:], out=P[:n, D * K:D * K + h])
        out.addmm_(E[:, s:s + step], P[:n])
    del P
    return out.index_select(1, cols).view(C, K, K)


class MeshAlsChunk(NamedTuple):
    """One chunk placed on a rank of a mesh (:func:`place_mesh_chunks`)."""
    rows: torch.Tensor     # int64[Cp] every target row id, on every rank
    idx_pad: torch.Tensor  # int32[Cp / n, P] this rank's rows' positives
    valid: torch.Tensor    # bool[Cp / n, P]


def place_mesh_chunks(chunks: List[AlsChunk], mesh) -> List[MeshAlsChunk]:
    """The chunks on a rank of ``mesh`` (``cymf_tpu/ops/als.py:378-409``,
    its mesh form): each chunk's ``C`` is padded to a multiple of the world
    size with sentinel rows (``2**31 - 1``: no rank owns them, no entry is
    valid), ``idx_pad``/``valid`` are cut to this rank's ``Cp / n`` rows
    and ``rows`` stays whole, for the scatter every rank makes of the rows
    it owns.  Unlike :func:`place_device_chunks`, sentinel rows stay: the
    ranks' slices must split every chunk evenly."""
    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    out = []
    for c in chunks:
        pad = -len(c.rows) % n
        rows = np.pad(c.rows.astype(np.int64), (0, pad),
                      constant_values=2**31 - 1)
        cn = len(rows) // n
        sl = slice(p * cn, (p + 1) * cn)
        out.append(MeshAlsChunk(
            upload(torch.from_numpy(rows), dev),
            upload(torch.from_numpy(np.pad(c.idx_pad, ((0, pad), (0, 0)))[sl]
                                    .copy()), dev),
            upload(torch.from_numpy(np.pad(c.valid, ((0, pad), (0, 0)))[sl]
                                    .copy()), dev)))
    return out


def gather_rows(Y: torch.Tensor, idx_pad: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """``Y[idx_pad] * valid``: the chunk's positives, ``(C, P, K)``, with
    the pads zeroed."""
    C, P = idx_pad.shape
    with span("als.gather"):
        sub = Y.index_select(0, idx_pad.reshape(-1)).view(C, P, -1)
        return sub * valid[..., None].to(Y.dtype)


def wmf_chunk_solve(Y, A0, idx_pad, valid, weight: float, *, solver: str):
    """Solve one WMF chunk: per row r,
    ``A = A0 + (weight-1) sum_{i in pos(r)} y_i y_i^T``,
    ``b = weight sum y_i`` (`wmf.pyx:161-168`).  Rows with no positives
    return zeros (`wmf.pyx:154-156`)."""
    return wmf_solve_rows(gather_rows(Y, idx_pad, valid), A0, valid, weight,
                          solver)


def wmf_solve_rows(sub, A0, valid, weight: float, solver: str):
    """The standard-form solve on gathered, pad-zeroed rows
    ``sub (C, P, K)``: what :func:`wmf_chunk_solve` does after its gather,
    and the sharded chunk after its row exchange.  The correction is
    formed in float32 (``A0`` is float32); ``b`` stays in ``sub``'s dtype,
    as in the JAX package.  Returns float32 rows."""
    dt = sub.dtype
    w = scalar(weight, dt)
    with span("als.correction"):
        subf = sub.float()
        A = torch.baddbmm(A0.expand(sub.shape[0], -1, -1), subf.mT, subf,
                          alpha=scalar(w - 1.0, dt))
        b = w * sub.sum(dim=1)
    x = get_solver(solver)(A, b)
    return torch.where(valid.any(dim=1, keepdim=True), x, 0.0)


def wmf_chunk_solve_woodbury(Y, A0inv, idx_pad, valid, weight: float, *,
                             solver: str = "cholesky"):
    """WMF chunk solve by the Woodbury identity, the same solution as
    :func:`wmf_chunk_solve`:

        x = (A0 + (c-1) U U^T)^{-1} (c U 1)
          = A0i b - T (I/(c-1) + U^T T)^{-1} (U^T A0i b),  T = A0i U

    Every large product contracts over ``K``, leaving a batched P x P
    solve; the trainer routes small-``P`` chunks here.  ``A0inv`` is the
    inverse of the half-sweep's shared ``Y^T Y + wd I``.  Requires
    ``weight > 1``; the explicit float32 inverse loses ~cond(A0) eps
    digits, so the trainer's auto routing also requires
    ``weight_decay >= 1e-3``.
    """
    return woodbury_core(gather_rows(Y, idx_pad, valid), A0inv, valid,
                         weight, solver)


def woodbury_core(sub, A0inv, valid, weight: float, solver: str):
    """The Woodbury solve on gathered, pad-zeroed rows ``sub (C, P, K)``;
    ``b`` in ``sub``'s dtype, the products in float32 (``A0inv`` is
    float32).  Returns float32 rows."""
    dt = sub.dtype
    w = scalar(weight, dt)
    with span("als.woodbury"):
        b = w * sub.sum(dim=1)                              # (C, K)
        sub = sub.float()
        T = sub @ A0inv.mT                                  # (C, P, K)
        P = sub.shape[1]
        eye = torch.eye(P, dtype=sub.dtype, device=sub.device)
        M = torch.baddbmm((eye / scalar(w - 1.0, dt)).expand(
            sub.shape[0], -1, -1), sub, T.mT)
        A0ib = b.float() @ A0inv.mT                         # (C, K)
        UtA0ib = (sub @ A0ib[..., None])[..., 0]            # (C, P)
        # padded P positions give zero rows of M; the identity keeps it
        # SPD, and their z entries multiply zero columns of T
        z = get_solver(solver)(M, UtA0ib)
        x = A0ib - (T.mT @ z[..., None])[..., 0]
        return torch.where(valid.any(dim=1, keepdim=True), x, 0.0)
