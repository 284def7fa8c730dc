"""The port's batched Cholesky (``ops/chol_kernel.py``) against the JAX
Pallas kernel, and the port's Cholesky solver routing.

On the CPU ``chol_inv_batched`` is its plain version (``cholesky_ex`` and
``solve_triangular``); the JAX side runs its Pallas kernel in interpret
mode.  Tolerances are the JAX package's own (`tests/test_chol_kernel.py`):
``|dL| <= 1e-4 max|L|`` and ``|Linv L - I| <= 1e-3``, for float32 sums
taken in another order.  The CUDA kernel is held against the plain version
on the card in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops.chol_kernel import chol_inv_batched as jax_chol_inv
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops.als import get_solver, resolve_chol_solver
from cymf_tpu_torch.ops.chol_kernel import chol_inv_batched

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _spd(rng, C, B):
    X = rng.standard_normal((C, B, 8)).astype(np.float32)
    return np.einsum("cki,cli->ckl", X, X) / 8 + np.eye(B, dtype=np.float32)


def _check(L, Linv, Lref):
    assert np.abs(L - Lref).max() <= 1e-4 * np.abs(Lref).max()
    assert np.abs(Linv @ Lref - np.eye(Lref.shape[-1])).max() <= 1e-3
    assert (np.triu(L, 1) == 0).all() and (np.triu(Linv, 1) == 0).all()


@pytest.mark.parametrize("C,B", [(8, 64), (128, 64), (6, 32)])
def test_chol_inv_matches_jax_kernel(C, B):
    A = _spd(np.random.default_rng(C + B), C, B)
    Lj, _ = jax_chol_inv(jnp.asarray(A), block=B, interpret=True)
    _kernels.reset_launches()
    L, Linv = chol_inv_batched(torch.from_numpy(A), B)
    assert not _kernels.launches           # a CPU tensor runs the plain form
    _check(L.numpy(), Linv.numpy(), np.array(Lj))


def test_chol_inv_odd_batch_and_strided_view():
    """C=262, the batch the JAX wrapper sent to XLA, against numpy; and the
    first diagonal block of a larger batch, a strided view."""
    A = _spd(np.random.default_rng(7), 262, 64)
    L, Linv = chol_inv_batched(torch.from_numpy(A), 64)
    _check(L.numpy(), Linv.numpy(), np.linalg.cholesky(A))
    big = _spd(np.random.default_rng(8), 5, 128)
    L, Linv = chol_inv_batched(torch.from_numpy(big)[:, :64, :64], 64)
    _check(L.numpy(), Linv.numpy(), np.linalg.cholesky(big[:, :64, :64]))


def test_chol_inv_not_spd_is_nan():
    """A matrix that is not SPD, or holds a NaN, comes out all NaN, as
    XLA's Cholesky gives; the others are untouched."""
    A = torch.from_numpy(_spd(np.random.default_rng(9), 4, 32))
    A[1] = -A[1]
    A[3, 10, 10] = float("nan")
    L, Linv = chol_inv_batched(A, 32)
    for c in (1, 3):
        assert torch.isnan(L[c]).all() and torch.isnan(Linv[c]).all()
    assert torch.isfinite(L[[0, 2]]).all()
    assert torch.isfinite(Linv[[0, 2]]).all()


def test_chol_inv_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="must be"):
        chol_inv_batched(torch.eye(64).expand(2, 64, 64), 32)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        chol_inv_batched(torch.empty(2, 64, 64, device="meta"), 64)


@pytest.mark.parametrize("mode,K,device,block,want", [
    ("auto", 256, CPU, None, "cholesky_blocked64"),
    ("auto", 256, CUDA, None, "cholesky_cuda64"),
    ("auto", 128, CUDA, None, "cholesky_cuda64"),
    ("auto", 64, CUDA, None, "cholesky_xla"),       # below the auto threshold
    ("auto", 144, CUDA, None, "cholesky_xla"),      # not divisible by 64
    ("auto", 144, CPU, None, "cholesky_xla"),
    ("auto", 256, CUDA, "32", "cholesky_cuda32"),
    ("auto", 256, CUDA, "256", "cholesky_xla"),     # not larger than block
    ("xla", 256, CUDA, None, "cholesky_xla"),
    ("blocked", 256, CUDA, None, "cholesky_blocked64"),
    ("blocked", 64, CPU, "32", "cholesky_blocked32"),  # forced below 128
    ("blocked", 512, CPU, "256", "cholesky_blocked256"),
    ("pallas", 256, CPU, None, "cholesky_cuda64"),
    ("pallas", 256, CUDA, None, "cholesky_cuda64"),
    ("pallas", 144, CUDA, None, "cholesky_xla"),
])
def test_resolve_chol_solver(monkeypatch, mode, K, device, block, want):
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", mode)
    if block is None:
        monkeypatch.delenv("CYMF_TPU_ALS_CHOL_BLOCK", raising=False)
    else:
        monkeypatch.setenv("CYMF_TPU_ALS_CHOL_BLOCK", block)
    assert resolve_chol_solver("cholesky", K, device) == want
    assert resolve_chol_solver("lu", K, device) == "lu"


def test_resolve_chol_solver_rejects(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "fast")
    with pytest.raises(ValueError, match="ALS_CHOL"):
        resolve_chol_solver("cholesky", 256, CPU)
    # a kernel block above 128 on a CUDA request
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "pallas")
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL_BLOCK", "256")
    with pytest.raises(ValueError, match="at most 128"):
        resolve_chol_solver("cholesky", 512, CUDA)
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "auto")
    with pytest.raises(ValueError, match="at most 128"):
        resolve_chol_solver("cholesky", 512, CUDA)
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL_BLOCK", "many")
    with pytest.raises(ValueError):
        resolve_chol_solver("cholesky", 256, CPU)


@pytest.mark.parametrize("name", ["cholesky_xla", "cholesky_blocked64",
                                  "cholesky_cuda64", "cholesky_cuda32",
                                  "lu"])
@pytest.mark.parametrize("C", [16, 262])
def test_solver_names_solve(name, C):
    """Every solver name solves K=128 systems; the kernel form runs the
    plain diagonal factor on CPU tensors at every C."""
    rng = np.random.default_rng(C)
    A = _spd(rng, C, 128)
    b = rng.standard_normal((C, 128)).astype(np.float32)
    ref = np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0]
    got = get_solver(name)(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-4
