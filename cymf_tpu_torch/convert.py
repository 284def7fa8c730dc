"""Moving state from the JAX package into the port.

:func:`packed_state_from_jax` turns the packed engine's arrays (fetched to
numpy, e.g. with ``jax.device_get``) into the port's tensors, so a step
can continue from the JAX engine's exact state, :func:`wide_state_from_jax`
does the same for the wide BPR engine's,
:func:`batch_state_from_jax` for the batch engines' (``packed="off"``), and
:func:`pallas_state_from_jax` does the same for a fused table of the
sequential engine (``engine="pallas"``).  :func:`from_arrays`
(and :func:`bpr_from_arrays` for BPR) builds a model that warm-starts from
learned tables, such as a JAX model's ``W`` and ``H``.  A model saved with
``cymf_tpu.<Model>.save`` loads with ``cymf_tpu_torch.<Model>.load``: both
packages share the npz format.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bpr import BPR
from .ops.pallas_engine import _N_STATE, LANES, segment_width


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def packed_state_from_jax(Wp, Hp, ow, oh, device):
    """``(Wp, Hp, ow, oh)`` as tensors on ``device``: a packed engine's
    packed table, logical table and their optimizer-state dicts (``{}``
    for sgd, ``{"accum"}`` for adagrad, ``{"m", "v"}`` for adam).  This
    covers each packed engine's state in the layout its port updates:

    - BPR and RelMF: the packed user table, the logical item table (for
      RelMF under device prep with ``1 / max(p_i, M)`` on lane ``K``) and
      the two states, as :func:`~cymf_tpu_torch.ops.packed_epoch.
      packed_bpr_epoch` and :mod:`~cymf_tpu_torch.ops.relmf_epoch` take
      them;
    - GloVe: ``(Zc, Zx, {"accum"}, {"accum"})``, the packed augmented
      central table, the logical augmented context table and their
      AdaGrad accumulators, as :func:`~cymf_tpu_torch.ops.glove_epoch.
      packed_glove_epoch` takes them."""
    return (_tensor(Wp, device), _tensor(Hp, device),
            {k: _tensor(v, device) for k, v in ow.items()},
            {k: _tensor(v, device) for k, v in oh.items()})


def wide_state_from_jax(Wd, Hd, ow, oh, device):
    """``(Wd, Hd, ow, oh)`` as tensors on ``device``: the wide engine's
    ``(rw, Kp)`` user and item tables and their optimizer-state dicts
    (``{}`` for sgd, ``{"accum"}`` for adagrad, ``{"m", "v"}`` for adam),
    as :func:`~cymf_tpu_torch.ops.wide_epoch.wide_bpr_epoch` takes them.
    The wide counterpart of :func:`packed_state_from_jax`."""
    return packed_state_from_jax(Wd, Hd, ow, oh, device)


def batch_state_from_jax(W, H, ow, oh, device):
    """``(W, H, ow, oh)`` as tensors on ``device``: the batch engine's
    logical user and item tables and their optimizer-state dicts of the
    same shapes (``{}`` for sgd, ``{"accum"}`` for adagrad, ``{"m", "v"}``
    for adam), as the ``_bpr_epoch``/``_relmf_epoch`` of
    :mod:`cymf_tpu_torch.models` and :mod:`cymf_tpu_torch.optim` take
    them.  The batch counterpart of :func:`wide_state_from_jax`."""
    for table, state in ((W, ow), (H, oh)):
        for k, v in state.items():
            if np.shape(v) != np.shape(table):
                raise ValueError(f"optimizer leaf {k!r} has shape "
                                 f"{np.shape(v)}, its table "
                                 f"{np.shape(table)}")
    return packed_state_from_jax(W, H, ow, oh, device)


def pallas_state_from_jax(Wp, K: int, optimizer: str, device
                          ) -> torch.Tensor:
    """A JAX fused table of the sequential engine (numpy, ``[rows, (1 +
    n_state) * 128]``, :func:`cymf_tpu.ops.pallas_engine.pack_table`) as
    the port's fused table on ``device``: each 128-lane segment cut to its
    first ``Kp = segment_width(K)`` columns.  ``K`` is the payload width
    (GloVe's augmented tables: ``K + 2``).  The lanes cut off carry no
    gradient in either package."""
    Wp = np.asarray(Wp, np.float32)
    n = 1 + _N_STATE[optimizer]
    if Wp.ndim != 2 or Wp.shape[1] != n * LANES:
        raise ValueError(f"a JAX fused {optimizer} table is [rows, "
                         f"{n * LANES}], got {Wp.shape}")
    Kp = segment_width(K)
    out = Wp.reshape(len(Wp), n, LANES)[:, :, :Kp].reshape(len(Wp), n * Kp)
    return _tensor(out, device)


def pallas_state_to_jax(P: torch.Tensor, K: int, optimizer: str
                        ) -> np.ndarray:
    """The inverse of :func:`pallas_state_from_jax`: the port's fused
    table as the JAX package's, numpy ``[rows, (1 + n_state) * 128]``,
    lanes beyond ``Kp`` as the JAX package packs them (parameters and adam
    moments 0, adagrad accumulators 1)."""
    n = 1 + _N_STATE[optimizer]
    Kp = segment_width(K)
    if P.dim() != 2 or P.shape[1] != n * Kp:
        raise ValueError(f"a fused {optimizer} table of K={K} is [rows, "
                         f"{n * Kp}], got {tuple(P.shape)}")
    rows = P.shape[0]
    out = np.zeros((rows, n, LANES), np.float32)
    if optimizer == "adagrad":
        out[:, 1, :] = 1.0
    out[:, :, :Kp] = P.detach().cpu().numpy().reshape(rows, n, Kp)
    return out.reshape(rows, n * LANES)


def from_arrays(cls, W, H, **hyper):
    """A ``cls`` model (:class:`BPR`, :class:`WMF`, :class:`ExpoMF` or
    :class:`RelMF`) holding the learned ``W`` (users x K) and ``H``
    (items x K); ``hyper`` goes to the constructor (``num_components``
    defaults to ``W``'s width).  Its next ``fit`` warm-starts from them."""
    W = np.asarray(W, np.float32)
    H = np.asarray(H, np.float32)
    hyper.setdefault("num_components", W.shape[1])
    model = cls(**hyper)
    model.W, model.H = W, H
    model._num_users, model._num_items = W.shape[0], H.shape[0]
    return model


def bpr_from_arrays(W, H, **hyper) -> BPR:
    """:func:`from_arrays` for :class:`BPR`."""
    return from_arrays(BPR, W, H, **hyper)
