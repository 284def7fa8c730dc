"""Row-sparse optimizers with the reference's exact update semantics.

Port of `cymf_tpu/optim.py`.  The reference optimizers
(`cymf/optimizer.pyx`) update only the (row, k) entries a sample touches.
A batch step here produces (rows, per-row gradients), duplicates are
combined by :func:`cymf_tpu_torch.ops.segment.dedup_rows`, and one
synchronous update writes the touched rows of the table and its state.

Deliberately replicated quirks (they affect convergence):

* AdaGrad accumulators start at **ones**, not zeros
  (`optimizer.pyx:69-70`), and there is no epsilon.
* Adam uses a **constant** bias correction ``1/(1-beta1)`` and
  ``1/(1-beta2)``: the reference keeps no timestep
  (`optimizer.pyx:150-160`).  Defaults beta1=0.9, beta2=0.999, eps=1e-8.

Tables and states are tensors of one dtype on one device
(:func:`cymf_tpu_torch.config.param_dtype`: float32 by default), updated IN
PLACE (call under ``torch.no_grad()``); the constants (learning rate,
Adam's betas and epsilon) are first rounded to that dtype, as the JAX
package's weakly typed scalars are (:func:`~cymf_tpu_torch.config.scalar`);
``update_rows`` and ``update_dense``
return ``(table, state)``, the same objects, as the JAX package's
functional forms return the new ones.  Rows at or past the table's length
are dropped, as XLA's ``mode="drop"`` scatters drop them: a dropped entry
adds ``-0.0`` (``x + -0.0 == x`` for every ``x``) or repeats another
entry's write, so it never changes a row, and no host sync is needed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import scalar
from .ops.segment import dedup_rows, scatter_add_rows

State = Dict[str, torch.Tensor]


def masked_addend(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``x`` where ``keep`` (per row), ``-0.0`` elsewhere: an addend that
    leaves any value it is added to unchanged."""
    return torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, -0.0)


def set_rows(dst: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> None:
    """``dst[tgt[p]] = vals[p]`` for every kept ``p`` (``tgt`` unique among
    them, in range), nothing else: each dropped position repeats the
    first kept position's write, or with none kept rewrites its row with
    its own value, so rows written twice get equal values in any order."""
    first = torch.argmax(keep.to(torch.uint8))
    t0 = tgt[first]
    v0 = torch.where(keep[first], vals[first], dst[t0])
    k = keep.view((-1,) + (1,) * (vals.dim() - 1))
    dst.index_copy_(0, torch.where(keep, tgt, t0).long(),
                    torch.where(k, vals, v0))


def _dedup(table, rows, grads):
    """:func:`dedup_rows` with the drop index at the table's length, then
    ``(tgt, grads, keep)``: in-range targets, the summed gradients, and
    which entries are kept (first occurrences of rows inside the table)."""
    drop = table.shape[0]
    rows, grads = dedup_rows(rows, grads, drop)
    return rows.clamp(max=drop - 1), grads, rows < drop


class SparseOptimizer:
    """Optimizer over row tables.

    ``init(table)`` builds the per-table state dict;
    ``update_rows(table, state, rows, grads)`` applies one synchronous
    sparse update: ``rows`` may hold duplicates and out-of-range "drop"
    entries (>= table rows).

    ``update_dense(table, state, pairs, rows_sorted=False)`` has the same
    semantics by another route: the per-sample gradients of ``pairs``, a
    list of ``(rows, grads)``, are summed into a table-shaped buffer and
    the update is one full-table pass masked to touched rows.
    ``rows_sorted`` is accepted for the JAX signature; it is a hint to
    XLA's scatter there and changes nothing here.
    """

    def init(self, table: torch.Tensor) -> State:
        raise NotImplementedError

    def update_rows(self, table: torch.Tensor, state: State,
                    rows: torch.Tensor, grads: torch.Tensor
                    ) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    def update_dense(self, table: torch.Tensor, state: State, pairs,
                     rows_sorted: bool = False
                     ) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    @staticmethod
    def _accumulate(table, pairs, with_mask: bool):
        """The gradient buffer (one fused ``index_add_`` over all pairs),
        and with ``with_mask`` the touched rows: those whose summed
        gradient is not exactly zero (a row hit only by masked samples
        sums to +-0 and is skipped, as the reference skips the sample,
        `bpr.pyx:166-167`)."""
        if len(pairs) == 1:
            rows, grads = pairs[0]
        else:  # one fused scatter beats several smaller ones
            rows = torch.cat([r for r, _ in pairs])
            grads = torch.cat([g for _, g in pairs])
        n = table.shape[0]
        gbuf = scatter_add_rows(torch.zeros_like(table), rows.clamp(max=n - 1),
                                masked_addend(grads, rows < n))
        if not with_mask:
            return gbuf, None
        return gbuf, torch.any(gbuf != 0, dim=-1, keepdim=True)


class Sgd(SparseOptimizer):
    """`optimizer.pyx:40-58`: ``param -= lr * grad``."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, table):
        return {}

    def update_rows(self, table, state, rows, grads):
        tgt, grads, keep = _dedup(table, rows, grads)
        lr = scalar(-self.learning_rate, table.dtype)
        table.index_add_(0, tgt, masked_addend(lr * grads, keep))
        return table, state

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # untouched rows have zero accumulated gradient: a no-op
        gbuf, _ = self._accumulate(table, pairs, with_mask=False)
        table.sub_(scalar(self.learning_rate, table.dtype) * gbuf)
        return table, state


class AdaGrad(SparseOptimizer):
    """`optimizer.pyx:60-82`: accumulators start at ones, no epsilon."""

    def __init__(self, learning_rate: float):
        self.learning_rate = float(learning_rate)

    def init(self, table):
        return {"accum": torch.ones_like(table)}

    def update_rows(self, table, state, rows, grads):
        tgt, grads, keep = _dedup(table, rows, grads)
        accum_new = state["accum"].index_select(0, tgt) + torch.square(grads)
        set_rows(state["accum"], tgt, accum_new, keep)
        delta = scalar(-self.learning_rate, table.dtype) * grads \
            * torch.rsqrt(accum_new)
        table.index_add_(0, tgt, masked_addend(delta, keep))
        return table, state

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # untouched rows: accum += 0 and delta = 0, a no-op
        gbuf, _ = self._accumulate(table, pairs, with_mask=False)
        accum = state["accum"].add_(torch.square(gbuf))
        table.sub_(scalar(self.learning_rate, table.dtype) * gbuf
                   * torch.rsqrt(accum))
        return table, state


class Adam(SparseOptimizer):
    """`optimizer.pyx:126-160`: sparse Adam with constant bias correction.

    A row is touched iff its summed gradient is not exactly zero, in both
    modes: a row hit only by masked-out samples (collisions, padding)
    keeps its moments, as the reference skips those samples.  As in the
    JAX package, a live sample whose gradient underflows to exactly zero
    is treated as untouched too (its gradient signal is zero either
    way)."""

    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.alpha = float(alpha)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)

    def init(self, table):
        return {"m": torch.zeros_like(table), "v": torch.zeros_like(table)}

    def _consts(self, dtype):
        """beta1, 1 - beta1, beta2, 1 - beta2, -alpha and epsilon in
        ``dtype`` (:func:`~cymf_tpu_torch.config.scalar`)."""
        return tuple(scalar(x, dtype) for x in (
            self.beta1, 1.0 - self.beta1, self.beta2, 1.0 - self.beta2,
            -self.alpha, self.epsilon))

    def _delta(self, m, v):
        # constant bias correction: deliberate parity with the reference
        _, c1, _, c2, na, eps = self._consts(m.dtype)
        return na * (m / c1) / (torch.sqrt(v / c2) + eps)

    def update_rows(self, table, state, rows, grads):
        tgt, grads, keep = _dedup(table, rows, grads)
        keep = keep & torch.any(grads != 0, dim=-1)
        b1, c1, b2, c2, _, _ = self._consts(table.dtype)
        m_new = b1 * state["m"].index_select(0, tgt) + c1 * grads
        v_new = (b2 * state["v"].index_select(0, tgt)
                 + c2 * torch.square(grads))
        set_rows(state["m"], tgt, m_new, keep)
        set_rows(state["v"], tgt, v_new, keep)
        table.index_add_(0, tgt,
                         masked_addend(self._delta(m_new, v_new), keep))
        return table, state

    def update_dense(self, table, state, pairs, rows_sorted=False):
        # the moments decay only on rows present in the batch (sparse-Adam
        # semantics, optimizer.pyx's per-element updates): a masked pass
        gbuf, touched = self._accumulate(table, pairs, with_mask=True)
        m, v = state["m"], state["v"]
        b1, c1, b2, c2, _, _ = self._consts(table.dtype)
        m.copy_(torch.where(touched, b1 * m + c1 * gbuf, m))
        v.copy_(torch.where(touched, b2 * v + c2 * torch.square(gbuf), v))
        table.add_(torch.where(touched, self._delta(m, v), 0.0))
        return table, state


def adagrad_kfold_rows(bias, accum, rows, g, lr: float, k_steps: int) -> None:
    """``k_steps`` consecutive AdaGrad steps with the constant gradient
    ``g`` ``(B, 1)`` on rows ``rows`` of the ``(V, 1)`` columns ``bias`` and
    ``accum``, in closed form, IN PLACE: ``delta = -lr g sum_{t=1..k}
    rsqrt(a0 + t g^2)``, ``accum += k g^2``.  ``rows`` are distinct
    (:func:`~cymf_tpu_torch.ops.segment.dedup_rows`' output) apart from
    those at or past ``V``, which are dropped."""
    drop = bias.shape[0]
    keep = rows < drop
    tgt = rows.clamp(max=drop - 1)
    a0 = accum.index_select(0, tgt)                      # (B, 1)
    t = torch.arange(1, k_steps + 1, dtype=bias.dtype, device=bias.device)
    denom = torch.sqrt(a0 + t[None, :] * torch.square(g))
    # the quotients and their sum in float32, rounded once to the bias's
    # dtype (XLA computes the op that feeds a bfloat16 sum in float32)
    delta = scalar(-lr, bias.dtype) * g[:, :1] * torch.sum(
        1.0 / denom.float(), dim=1, keepdim=True).to(bias.dtype)
    set_rows(accum, tgt, a0 + scalar(float(k_steps), bias.dtype)
             * torch.square(g[:, :1]), keep)
    bias.index_add_(0, tgt, masked_addend(delta, keep))


def choose_update_mode(mode: str, batch_rows: int, table_rows: int) -> str:
    """The update a batch engine makes: ``mode`` ("dense" or "sparse"), or
    for "auto" dense when the batch covers enough of the table that a
    full-table pass is cheaper than sorted row-scatters."""
    if mode != "auto":
        return mode
    return "dense" if batch_rows * 16 >= table_rows else "sparse"


def make_optimizer(name: str, learning_rate: float) -> SparseOptimizer:
    """Optimizer whitelist matching `cymf/bpr.pyx:65-66`."""
    if name == "adam":
        return Adam(alpha=learning_rate)
    if name == "adagrad":
        return AdaGrad(learning_rate)
    if name == "sgd":
        return Sgd(learning_rate)
    raise Exception(f"{name} is invalid.")
