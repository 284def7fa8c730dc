"""Ranking metrics with the reference's exact (non-standard) definitions.
Port of `cymf_tpu/evaluation/metrics.py`, its formulas unchanged.

* DCG (`metrics.pyx:24-43`): the slot-0 label counts undiscounted and
  unconditionally; slots ``1 <= i < k`` add ``y[i]/log2(i+1)``; the total
  is divided by the positives in the whole candidate list.
* Recall (`metrics.pyx:71-85`): hits in top-k / positives in list.
* MAP (`metrics.pyx:109-125`): at each hit ``i < k`` adds
  ``(#positives at ranks <= i) / (i+1)``, over positives in list.
* ``*_with_ips``: labels inverse-propensity weighted, self-normalized by
  ``sum_i y[i]/p[i]`` over the full list.

Every form returns 0 where the list has no positives.  Three families:

* scalar numpy functions with the reference's public signatures
  (``dcg_at_k(y_true_sorted_by_score, k)`` etc.);
* ``*_at_k*_batch`` over ``[..., L]`` label tensors sorted by descending
  score (``props``: the propensity of the item in each slot);
* ``*_topk_batch``, the evaluator's: ``labels_topk`` / ``props_topk`` are
  the top-``kmax`` slots of each candidate list (``kmax >= max(k, 1)``),
  sorted by descending score; ``total_pos`` / ``sn_total`` are the
  full-list denominators.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import upload

__all__ = [
    "dcg_at_k", "recall_at_k", "average_precision_at_k",
    "dcg_at_k_with_ips", "recall_at_k_with_ips",
    "average_precision_at_k_with_ips",
    "dcg_at_k_batch", "recall_at_k_batch", "average_precision_at_k_batch",
    "dcg_at_k_with_ips_batch", "recall_at_k_with_ips_batch",
    "average_precision_at_k_with_ips_batch",
    "dcg_topk_batch", "recall_topk_batch", "average_precision_topk_batch",
    "dcg_with_ips_topk_batch", "recall_with_ips_topk_batch",
    "average_precision_with_ips_topk_batch",
]


def _like(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return upload(torch.as_tensor(arr, dtype=ref.dtype), ref.device)


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


def dcg_at_k_batch(labels, k: int):
    return _safe_div(torch.sum(labels * _dcg_weights(labels, k), dim=-1),
                     torch.sum(labels, dim=-1))


def dcg_at_k_with_ips_batch(labels, props, k: int):
    wl = labels / props
    return _safe_div(torch.sum(wl * _dcg_weights(labels, k), dim=-1),
                     torch.sum(wl, dim=-1))


def recall_at_k_batch(labels, k: int):
    return _safe_div(torch.sum(labels * _topk_mask(labels, k), dim=-1),
                     torch.sum(labels, dim=-1))


def recall_at_k_with_ips_batch(labels, props, k: int):
    wl = labels / props
    return _safe_div(torch.sum(wl * _topk_mask(labels, k), dim=-1),
                     torch.sum(wl, dim=-1))


def average_precision_at_k_batch(labels, k: int):
    cum = torch.cumsum(labels, dim=-1)  # includes the current slot
    return _safe_div(torch.sum(labels * _topk_mask(labels, k) * cum
                               / _ranks(labels), dim=-1),
                     torch.sum(labels, dim=-1))


def average_precision_at_k_with_ips_batch(labels, props, k: int):
    wl = labels / props
    sncum = torch.cumsum(wl, dim=-1)
    return _safe_div(torch.sum(labels * _topk_mask(labels, k) * sncum
                               / _ranks(labels), dim=-1),
                     torch.sum(wl, dim=-1))


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


# Scalar numpy forms (public API parity with metrics.pyx).

def dcg_at_k(y_true_sorted_by_score, k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    counter = y.sum()
    if counter == 0.0:
        return 0.0
    score = y[0]
    i = np.arange(1, len(y))
    window = i < k
    score += float(np.sum(y[1:][window] / np.log2(i[window] + 1.0)))
    return float(score / counter)


def dcg_at_k_with_ips(y_true_sorted_by_score, p_scores_sorted_by_score,
                      k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    p = np.asarray(p_scores_sorted_by_score, dtype=np.float64)
    sn = float(np.sum(y / p))
    if sn == 0.0:
        return 0.0
    score = y[0] / p[0]
    i = np.arange(1, len(y))
    window = i < k
    score += float(np.sum(y[1:][window] / np.log2(i[window] + 1.0)
                          / p[1:][window]))
    return float(score / sn)


def recall_at_k(y_true_sorted_by_score, k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    counter = y.sum()
    if counter == 0.0:
        return 0.0
    return float(y[:k].sum() / counter)


def recall_at_k_with_ips(y_true_sorted_by_score, p_scores_sorted_by_score,
                         k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    p = np.asarray(p_scores_sorted_by_score, dtype=np.float64)
    sn = float(np.sum(y / p))
    if sn == 0.0:
        return 0.0
    return float(np.sum(y[:k] / p[:k]) / sn)


def average_precision_at_k(y_true_sorted_by_score, k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    counter = y.sum()
    if counter == 0.0:
        return 0.0
    cum = np.cumsum(y)
    ranks = np.arange(len(y)) + 1.0
    hits = (y == 1) & (np.arange(len(y)) < k)
    return float(np.sum(cum[hits] / ranks[hits]) / counter)


def average_precision_at_k_with_ips(y_true_sorted_by_score,
                                    p_scores_sorted_by_score,
                                    k: int) -> float:
    y = np.asarray(y_true_sorted_by_score, dtype=np.float64)
    p = np.asarray(p_scores_sorted_by_score, dtype=np.float64)
    sn_total = float(np.sum(y / p))
    if sn_total == 0.0:
        return 0.0
    sncum = np.cumsum(y / p)
    ranks = np.arange(len(y)) + 1.0
    hits = (y == 1) & (np.arange(len(y)) < k)
    return float(np.sum(sncum[hits] / ranks[hits]) / sn_total)
