"""Batched Cholesky factor and its inverse: the diagonal blocks of the
blocked ALS solve.  Port of `cymf_tpu/ops/chol_kernel.py`.

``chol_inv_batched(A, block)`` takes ``C`` symmetric positive definite
``block x block`` float32 matrices and returns ``(L, Linv)``: the lower
Cholesky factors, with exact zeros above the diagonal, and their
inverses.  On a CUDA tensor it launches the hand-written kernel of
``csrc/chol_inv.cu`` (one CTA per matrix, both factors from one
right-looking column loop in shared memory); on a CPU tensor it runs
:func:`chol_inv_batched_plain`.  A matrix that is not SPD comes out NaN in
both outputs, in both versions, as XLA's Cholesky gives: nothing syncs
with the host to raise.

Left behind: the JAX wrapper's XLA fallback for batches whose tile
``G`` would fall below 8 (`chol_kernel.py:97-106`) works round a Mosaic
relayout; the CUDA kernel takes every ``C``.
"""

from __future__ import annotations

import torch

from . import _kernels

MAX_BLOCK = 128  # two (B, B + 1) f32 buffers in one CTA's shared memory


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
    """Plain PyTorch version of :func:`chol_inv_batched`: ``cholesky_ex``
    and ``solve_triangular`` against the identity."""
    L = cholesky_nan(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def chol_inv_batched(A: torch.Tensor, block: int = 64):
    """``A (C, block, block)`` SPD float32 -> ``(L, Linv)``, both
    ``(C, block, block)`` float32 and contiguous.

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
    if A.dtype != torch.float32:
        raise ValueError(f"A has dtype {A.dtype}, expected torch.float32")
    if block > MAX_BLOCK:
        raise ValueError(f"block {block} > {MAX_BLOCK}: the kernel's two "
                         "buffers do not fit in shared memory")
    if A.shape[0] and A.stride(2) != 1:
        raise ValueError("A must have unit column stride")
    C = A.shape[0]
    dev = A.device
    L = torch.empty((C, block, block), dtype=torch.float32, device=dev)
    Linv = torch.empty_like(L)
    if C == 0:
        return L, Linv
    with torch.cuda.device(dev):
        err = _kernels.lib().cymf_chol_inv_batched(
            A.data_ptr(), A.stride(0), A.stride(1), L.data_ptr(),
            Linv.data_ptr(), C, block, _kernels.stream(dev))
    _kernels.check(err, "chol_inv_batched")
    _kernels.launches["chol_inv_batched"] += 1
    return L, Linv
