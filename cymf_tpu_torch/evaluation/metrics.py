"""Ranking metrics with the reference's exact (non-standard) definitions:
the top-k-truncated batch forms of `cymf_tpu/evaluation/metrics.py`
(`:131-170`), on tensors.

* DCG (`metrics.pyx:24-43`): the slot-0 label counts undiscounted and
  unconditionally; slots ``1 <= i < k`` add ``y[i]/log2(i+1)``; the total
  is divided by the positives in the whole candidate list.
* Recall (`metrics.pyx:71-85`): hits in top-k / positives in list.
* MAP (`metrics.pyx:109-125`): at each hit ``i < k`` adds
  ``(#positives at ranks <= i) / (i+1)``, over positives in list.
* ``*_with_ips``: labels inverse-propensity weighted, self-normalized by
  ``sum_i y[i]/p[i]`` over the full list.

``labels_topk`` / ``props_topk`` are the top-``kmax`` slots of each
candidate list (``kmax >= max(k, 1)``), sorted by descending score;
``total_pos`` / ``sn_total`` are the full-list denominators.  Every form
returns 0 where the list has no positives.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dcg_topk_batch", "recall_topk_batch", "average_precision_topk_batch",
    "dcg_with_ips_topk_batch", "recall_with_ips_topk_batch",
    "average_precision_with_ips_topk_batch",
]


def _like(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)


def _dcg_weights(ref: torch.Tensor, k: int) -> torch.Tensor:
    length = ref.shape[-1]
    pos = np.arange(length)
    disc = np.ones(length)
    disc[1:] = 1.0 / np.log2(pos[1:] + 1.0)
    in_window = (pos == 0) | (pos < k)
    return _like(disc * in_window, ref)


def _topk_mask(ref: torch.Tensor, k: int) -> torch.Tensor:
    return _like(np.arange(ref.shape[-1]) < k, ref)


def _ranks(ref: torch.Tensor) -> torch.Tensor:
    return _like(np.arange(ref.shape[-1]) + 1.0, ref)


def _safe_div(num, den):
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def dcg_topk_batch(labels_topk, total_pos, k: int):
    w = _dcg_weights(labels_topk, k)
    return _safe_div(torch.sum(labels_topk * w, dim=-1), total_pos)


def recall_topk_batch(labels_topk, total_pos, k: int):
    m = _topk_mask(labels_topk, k)
    return _safe_div(torch.sum(labels_topk * m, dim=-1), total_pos)


def average_precision_topk_batch(labels_topk, total_pos, k: int):
    m = _topk_mask(labels_topk, k)
    cum = torch.cumsum(labels_topk, dim=-1)
    return _safe_div(
        torch.sum(labels_topk * m * cum / _ranks(labels_topk), dim=-1),
        total_pos)


def dcg_with_ips_topk_batch(labels_topk, props_topk, sn_total, k: int):
    w = _dcg_weights(labels_topk, k)
    return _safe_div(torch.sum(labels_topk / props_topk * w, dim=-1),
                     sn_total)


def recall_with_ips_topk_batch(labels_topk, props_topk, sn_total, k: int):
    m = _topk_mask(labels_topk, k)
    return _safe_div(torch.sum(labels_topk / props_topk * m, dim=-1),
                     sn_total)


def average_precision_with_ips_topk_batch(labels_topk, props_topk, sn_total,
                                          k: int):
    m = _topk_mask(labels_topk, k)
    sncum = torch.cumsum(labels_topk / props_topk, dim=-1)
    return _safe_div(
        torch.sum(labels_topk * m * sncum / _ranks(labels_topk), dim=-1),
        sn_total)
