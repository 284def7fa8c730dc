"""Global configuration for the PyTorch port of cymf-tpu.

Port of `cymf_tpu/config.py`.  Parameters and accumulation are float32 by
default.  :func:`set_param_dtype` switches the dtype of the embedding
tables and optimizer state (e.g. to bfloat16, for bandwidth-bound
experiments), as in the JAX package, and the engines that honour it
follow the JAX package engine by engine: the batch engines of BPR, RelMF
and GloVe, WMF and ExpoMF, the evaluators and ``recommend``.  The fused
and sequential engines keep float32 tables under any switch, since their
CUDA kernels take float32 only.

Where a Python scalar meets an array of the param dtype, the JAX package
converts the scalar to that dtype first (a weakly typed constant);
:func:`scalar` gives the port the same value.

The port names its device explicitly (``device=`` on the trainers and
evaluators); :func:`default_device`, the card, is what they use when none
is given.
"""

from __future__ import annotations

import functools

import torch

_param_dtype = torch.float32

# the names that jnp.dtype takes in the JAX package's tests
_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def param_dtype() -> torch.dtype:
    """dtype used for embedding tables and optimizer state."""
    return _param_dtype


def set_param_dtype(dtype) -> None:
    """Set the dtype of the tables and optimizer state: ``torch.float32``
    (the default), ``torch.bfloat16`` or ``torch.float16``, or one of the
    names ``"float32"``, ``"bfloat16"``, ``"float16"``.  Anything else
    raises ``ValueError``."""
    global _param_dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPE_NAMES:
            raise ValueError(f"param dtype {dtype!r} is not one of "
                             f"{sorted(_DTYPE_NAMES)}")
        dtype = _DTYPE_NAMES[dtype]
    if dtype not in _DTYPE_NAMES.values():
        raise ValueError(f"param dtype {dtype!r} is not one of "
                         f"{sorted(_DTYPE_NAMES)}")
    _param_dtype = dtype


# Index dtype for user/item ids.  int32 covers every supported dataset
# (ML-20M has 2e7 interactions, 1.4e5 users, 2.7e4 items).
index_dtype = torch.int32


@functools.lru_cache(maxsize=256)
def scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float: the value the JAX
    package computes with where the Python scalar ``x`` meets an array of
    ``dtype``.  ``x`` itself for float32 and wider, where PyTorch rounds
    the scalar the same way."""
    if dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def default_device() -> torch.device:
    """The first CUDA device, ``cuda:0``, whether or not one is visible:
    the port runs on the card unless the caller asks for the CPU
    (``device="cpu"``, where every kernel wrapper runs its plain PyTorch
    version).  Without a card the first allocation on it fails with
    PyTorch's own error; nothing falls back to the CPU."""
    return torch.device("cuda", 0)
