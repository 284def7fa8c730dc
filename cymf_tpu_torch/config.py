"""Global configuration for the PyTorch port of cymf-tpu.

Parameters and accumulation stay float32, as in the JAX package
(`cymf_tpu/config.py`): the hand-written CUDA kernels take float32 only.
The port names its device explicitly (``device=`` on the trainers and
evaluators); :func:`default_device`, the card, is what they use when none
is given.
"""

from __future__ import annotations

import torch

_param_dtype = torch.float32


def param_dtype() -> torch.dtype:
    """dtype used for embedding tables and optimizer state."""
    return _param_dtype


def default_device() -> torch.device:
    """The first CUDA device, ``cuda:0``, whether or not one is visible:
    the port runs on the card unless the caller asks for the CPU
    (``device="cpu"``, where every kernel wrapper runs its plain PyTorch
    version).  Without a card the first allocation on it fails with
    PyTorch's own error; nothing falls back to the CPU."""
    return torch.device("cuda", 0)
