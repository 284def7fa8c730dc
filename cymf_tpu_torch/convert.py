"""Moving state from the JAX package into the port.

:func:`packed_state_from_jax` turns the packed engine's arrays (fetched to
numpy, e.g. with ``jax.device_get``) into the port's tensors, so a step
can continue from the JAX engine's exact state.  :func:`from_arrays`
(and :func:`bpr_from_arrays` for BPR) builds a model that warm-starts from
learned tables, such as a JAX model's ``W`` and ``H``.  A model saved with
``cymf_tpu.<Model>.save`` loads with ``cymf_tpu_torch.<Model>.load``: both
packages share the npz format.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bpr import BPR


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
