"""Batched Cholesky factor and its inverse: the diagonal blocks of the
blocked ALS solve.  Port of `cymf_tpu/ops/chol_kernel.py`.

``chol_inv_batched(A, block)`` takes ``C`` symmetric positive definite
``block x block`` matrices and returns ``(L, Linv)``: the lower Cholesky
factors, with exact zeros above the diagonal, and their inverses, in
float32.  An ``A`` of another float dtype (bfloat16, float16) is cast to
float32 at entry, as the JAX wrapper casts it (`chol_kernel.py:102`,
`:120`): the kernel and its plain version work in float32 only.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/chol_inv.cu``
(a thread, or two at ``block > 64``, per row of a matrix, holding in
registers that row of ``A`` until its pivot, then that column of
``Linv``; one named barrier per right-looking column step; a matrix
smaller than 64 or 128 padded with the identity); :func:`chol_inv_twin`
is its column step in Python.  On a CPU tensor it runs :func:`chol_inv_batched_plain`.  A matrix
that is not SPD comes out NaN in both outputs, in both versions, as XLA's
Cholesky gives: nothing syncs with the host to raise.

Left behind: the JAX wrapper's XLA fallback for batches whose tile
``G`` would fall below 8 (`chol_kernel.py:97-106`) works round a Mosaic
relayout; the CUDA kernel takes every ``C``.
"""

from __future__ import annotations

import torch

from . import _kernels

MAX_BLOCK = 128  # the kernel's larger size: two threads' registers a row
                 # and a (128, 129) f32 staging tile in shared memory


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of ``A [..., K, K]`` by
    ``torch.linalg.cholesky_ex``, which does not sync with the host on CUDA
    (``cholesky`` does, to raise); a matrix that is not SPD, or whose
    factor is not finite (a NaN pivot passes ``cholesky_ex``'s check), gets
    NaN in every entry."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], L, float("nan"))


def chol_inv_batched_plain(A: torch.Tensor):
    """Plain PyTorch version of :func:`chol_inv_batched`: ``A`` cast to
    float32, then ``cholesky_ex`` and ``solve_triangular`` against the
    identity."""
    A = A.float()
    L = cholesky_nan(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def chol_inv_twin(A: torch.Tensor, size: int | None = None):
    """The kernel's column step in Python, on ``A (C, B, B)``: returns
    ``(L, Linv, pad)``, ``pad`` the padded threads' registers after the
    last step taken (``(C, size - B, size)``).

    ``A``'s lower triangle is padded with the identity to ``size`` (64 for
    ``B <= 64``, else 128), ``diag(A, I)``.  Thread ``i`` keeps one array
    ``w[i, k]``, index ``j + k`` at step ``j``: row ``i`` of A while ``j <=
    i`` (its entries past column ``i`` are never read), then column ``i``
    of ``Z`` (``L Z = I``; its entries above row ``i`` are zero, so they
    need no register before).  Step ``j < B``: every row ``i >= j``
    publishes ``w[i, 0]`` at ``i - j`` of the column vector; every thread
    reads the pivot ``d``, ``s = 1/sqrt(d)``, and takes ``L[i, j] = w[i,
    0] s`` for ``i > j`` (``d s`` on the diagonal) and ``Linv[j, i] = w[i,
    0] s`` for ``i < j`` (``s`` at ``i = j``, zero above); then shifts its
    array against the vector: ``w[i, k] <- keep w[i, k + 1] - mult colv[k
    + 1]``, ``mult = L[i, j] s`` for ``i > j`` and ``Linv[j, i] s`` for
    ``i <= j``, ``keep = 0`` at ``i = j`` (the column of Linv starts
    there) and 1 elsewhere.  The steps ``j >= B`` would touch only the
    identity block and are not taken.  A pivot that is not > 0 makes the
    matrix NaN."""
    C, B, _ = A.shape
    N = size or (64 if B <= 64 else 128)
    dev = A.device
    w = torch.zeros((C, N, N), dtype=torch.float32, device=dev)
    w[:, :B, :B] = torch.tril(A.float())
    w[:, B:, B:] = torch.eye(N - B, device=dev)
    L = torch.zeros((C, N, N), dtype=torch.float32, device=dev)
    Linv = torch.zeros_like(L)
    bad = torch.zeros(C, dtype=torch.bool, device=dev)
    rows = torch.arange(N, device=dev)
    zero = torch.zeros((C, N, 1), device=dev)
    for j in range(B):
        w0 = w[:, :, 0]
        colv = torch.zeros((C, N), dtype=torch.float32, device=dev)
        colv[:, :N - j] = w0[:, j:]
        d = colv[:, 0]
        s = torch.rsqrt(d)[:, None]
        bad |= ~(d > 0)
        lij = torch.where(rows > j, w0 * s, 0.0)
        zj = torch.where(rows < j, w0 * s, torch.where(rows == j, s, 0.0))
        L[:, j:, j] = torch.where(rows[j:] == j, d[:, None] * s, lij[:, j:])
        Linv[:, j] = zj
        mult = torch.where(rows > j, lij * s, zj * s)[:, :, None]
        keep = (rows != j).float()[None, :, None]
        w = torch.cat([w[:, :, 1:] * keep - mult * colv[:, None, 1:], zero],
                      dim=2)
    nan = torch.full((), float("nan"), device=dev)
    L = torch.where(bad[:, None, None], nan, torch.tril(L[:, :B, :B]))
    Linv = torch.where(bad[:, None, None], nan, Linv[:, :B, :B])
    return L, Linv, w[:, B:]


def chol_inv_batched(A: torch.Tensor, block: int = 64):
    """``A (C, block, block)`` SPD -> ``(L, Linv)``, both
    ``(C, block, block)`` float32 and contiguous.  A bfloat16 or float16
    ``A`` is cast to float32 first (a contiguous copy the kernel reads).

    On CUDA, ``A`` may be a strided view, such as the diagonal block of a
    larger batch of matrices: the kernel reads it in place through its
    batch and row strides, and needs only unit column stride.  ``block``
    must be at most :data:`MAX_BLOCK`.  Each launch adds one to
    ``_kernels.launches["chol_inv_batched"]``.
    """
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[1] != block:
        raise ValueError(f"A must be (C, {block}, {block}), got "
                         f"{tuple(A.shape)}")
    if A.device.type == "cpu":
        return chol_inv_batched_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"chol_inv_batched runs on cpu or cuda, not "
                         f"{A.device}")
    if A.dtype in (torch.bfloat16, torch.float16):
        A = A.float()
    if A.dtype != torch.float32:
        raise ValueError(f"A has dtype {A.dtype}, expected a float32, "
                         "bfloat16 or float16 tensor")
    if block > MAX_BLOCK:
        raise ValueError(f"block {block} > {MAX_BLOCK}: the kernel's rows "
                         "do not fit its registers and shared memory")
    if A.shape[0] and A.stride(2) != 1:
        raise ValueError("A must have unit column stride")
    C = A.shape[0]
    dev = A.device
    L = torch.empty((C, block, block), dtype=torch.float32, device=dev)
    Linv = torch.empty_like(L)
    if C == 0:
        return L, Linv
    _kernels.launch("chol_inv_batched", dev, A, A.stride(0), A.stride(1), L,
                    Linv, C, block)
    return L, Linv
