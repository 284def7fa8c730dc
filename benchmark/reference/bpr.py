"""A BPR fit, worked out again in plain PyTorch from the fit's inputs.

The semantics the trainer documents (``cymf_tpu_torch/models/bpr.py``,
``ops/packed_epoch.py``), written out directly over logical ``(rows, K)``
tables:

- the interactions in CSR order, shuffled once with numpy's legacy
  ``RandomState`` (the trainer draws from the global one; the benchmark
  seeds it before each fit), cut into steps of ``batch`` samples (padded
  at the end), each step sorted by user;
- each epoch's negatives from the native prep's stream (:mod:`.stream`);
  a sample is live when it is no padding and its negative is not a
  positive of its user;
- one synchronous step: every live sample's gradient from the tables
  before the step, weight decay ``wd * n_r * row`` on each row hit by
  ``n_r`` live samples, and Adam with a constant bias correction on the
  rows a live sample hit (the others keep their moments and values).

``dtype`` is the precision of the tables, moments and arithmetic: float32
is the reference, bfloat16 the lower-precision control.  ``keep`` (a
fault for the harness's own tests) keeps that share of each step's
samples live.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from . import stream

PAD_USER = 2**31 - 1
# epochs of negatives generated together (~1.6 GB of stream words at
# 151 x 131,072 steps)
EPOCHS_AT_ONCE = 10


def fit_batches(X, shuffle_seed: int, batch: int):
    """``(u2, i2)`` int32 ``[S, B]``: the fit's steps, as the trainer cuts
    them (``B`` rounded up to a multiple of 1024, padding users last)."""
    users, items = X.nonzero()
    order = np.arange(len(users))
    np.random.RandomState(shuffle_seed).shuffle(order)
    users = users[order].astype(np.int32)
    items = items[order].astype(np.int32)
    N = len(users)
    B = -(-min(batch, max(N, 1)) // 1024) * 1024
    S = max(1, -(-N // B))
    pad = S * B - N
    users = np.concatenate([users, np.full(pad, PAD_USER, np.int32)])
    items = np.concatenate([items, np.zeros(pad, np.int32)])
    u2, i2 = users.reshape(S, B), items.reshape(S, B)
    o = np.argsort(u2, axis=1, kind="stable")
    return np.take_along_axis(u2, o, 1), np.take_along_axis(i2, o, 1)


class BprReference:
    """The fit's state on ``device``; :meth:`epoch` runs one epoch."""

    def __init__(self, X, W0, H0, *, shuffle_seed: int, fit_seed: int,
                 lr: float, weight_decay: float, batch: int, device,
                 dtype=torch.float32, keep: float = 1.0):
        self.U, self.I = X.shape
        self.dev, self.dtype = device, dtype
        self.lr, self.wd = float(lr), float(weight_decay)
        self.fit_seed, self.keep = int(fit_seed), float(keep)
        u2, i2 = fit_batches(X, shuffle_seed, batch)
        self.u2 = torch.from_numpy(u2).to(device)
        self.i2 = torch.from_numpy(i2).to(device)
        coo = X.tocoo()
        keys = np.sort(coo.row.astype(np.int64) * self.I + coo.col)
        self.keys = torch.from_numpy(keys).to(device)
        self.W = torch.as_tensor(W0).to(device, dtype).clone()
        self.H = torch.as_tensor(H0).to(device, dtype).clone()
        self.mW, self.vW = torch.zeros_like(self.W), torch.zeros_like(self.W)
        self.mH, self.vH = torch.zeros_like(self.H), torch.zeros_like(self.H)
        # rows a live sample hit, summed over the steps run (the model
        # work that ``roofline.bpr_step`` counts)
        self.rows_hit = torch.zeros(2, dtype=torch.int64, device=device)
        self.samples = 0
        self._negs = {}

    def _positive(self, u, j):
        key = u.long() * self.I + j.long()
        pos = torch.searchsorted(self.keys, key).clamp(max=len(self.keys) - 1)
        return self.keys[pos] == key

    def _adam(self, T, m, v, g, hit):
        b1, b2, eps = 0.9, 0.999, 1e-8
        mask = hit[:, None]
        m.copy_(torch.where(mask, b1 * m + (1 - b1) * g, m))
        v.copy_(torch.where(mask, b2 * v + (1 - b2) * g * g, v))
        step = -self.lr * (m / (1 - b1)) / (torch.sqrt(v / (1 - b2)) + eps)
        T.add_(torch.where(mask, step, torch.zeros_like(step)))

    @torch.no_grad()
    def epoch(self, e: int) -> None:
        S, B = self.u2.shape
        if e not in self._negs:
            group = range(e, e + EPOCHS_AT_ONCE)
            self._negs = dict(zip(group, stream.negatives(
                self.fit_seed, group, S, B, self.I, self.dev)))
        j2 = self._negs.pop(e)
        for t in range(S):
            u, i, j = self.u2[t], self.i2[t], j2[t]
            live = (u < self.U) & ~self._positive(u, j)
            if self.keep < 1.0:
                live &= torch.arange(B, device=self.dev) < int(self.keep * B)
            m = live.to(self.dtype)
            uc = torch.where(live, u, torch.zeros_like(u)).long()
            il, jl = i.long(), j.long()
            wu, hi, hj = self.W[uc], self.H[il], self.H[jl]
            x = ((hi - hj) * wu).sum(1, keepdim=True)
            sig = torch.sigmoid(-x)
            gw = -(sig * (hi - hj)) * m[:, None]
            q = sig * wu * m[:, None]
            nW = torch.zeros(self.U, dtype=self.dtype, device=self.dev)
            nW.index_add_(0, uc, m)
            gW = torch.zeros_like(self.W).index_add_(0, uc, gw)
            gW += self.wd * nW[:, None] * self.W
            nH = torch.zeros(self.I, dtype=self.dtype, device=self.dev)
            nH.index_add_(0, il, m).index_add_(0, jl, m)
            gH = torch.zeros_like(self.H).index_add_(0, jl, q)
            gH.index_add_(0, il, -q)
            gH += self.wd * nH[:, None] * self.H
            self._adam(self.W, self.mW, self.vW, gW, nW > 0)
            self._adam(self.H, self.mH, self.vH, gH, nH > 0)
            self.rows_hit[0] += (nW > 0).sum()
            self.rows_hit[1] += (nH > 0).sum()
            self.samples += B

    def tables(self):
        return self.W.float(), self.H.float()


def reference(X, W0, H0, cfg: dict, sizes: dict, *, shuffle_seed: int,
              fit_seed: int, device, control: bool = False,
              keep: float = 1.0) -> BprReference:
    """The fit a configuration of ``model: BPR`` describes; ``control``:
    in bfloat16."""
    h = cfg["hyper"]
    return BprReference(
        X, W0, H0, shuffle_seed=shuffle_seed, fit_seed=fit_seed,
        lr=h["learning_rate"], weight_decay=h["weight_decay"],
        batch=sizes["batch_size"], device=device, keep=keep,
        dtype=torch.bfloat16 if control else torch.float32)


def judge(ref: BprReference, W, H, X, cfg: dict) -> dict:
    """Numbers compared beyond the tables' gaps: none for BPR."""
    return {}


def work(ref: BprReference, X, sizes: dict, epochs: int) -> tuple:
    """``(flops, bytes)`` of the whole fit :meth:`BprReference.epoch`
    replayed: the rows its live samples hit, step by step."""
    w_rows, h_rows = (int(x) for x in ref.rows_hit.cpu())
    return roofline.bpr_step(w_rows, h_rows, ref.samples,
                             sizes["num_components"])
