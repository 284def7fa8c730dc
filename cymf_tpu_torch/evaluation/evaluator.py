"""Sampled-negative ranking evaluator.

Port of `cymf_tpu/evaluation/evaluator.py`, with the behaviour of
`cymf/evaluator.pyx`:

* candidates per user = all test positives (label 1) + ``num_negatives``
  uniform negatives rejection-sampled against train+test positives
  (`evaluator.pyx:95-111`), exactly that many per user;
* scores = ``H[items] @ W[user]``, one ``(C, L, K) x (C, K)`` contraction
  per user chunk, ranked by (score descending, candidate index
  ascending), as ``jax.lax.top_k`` ranks (``recommend._stable_topk``;
  invalid slots at ``-inf``): equal scores put the positives, which come
  first in a user's candidate list, ahead of the negatives;
* metrics are averaged over **all** users, users without test positives
  contributing 0 (`evaluator.pyx:91-92`);
* IPS propensities = per-item mean of the test matrix, clipped at 1e-4
  (`evaluator.pyx:50`), gathered by candidate item id (the reference's
  sort-position indexing bug, `evaluator.pyx:114`, is not replicated).

The user chunking is the JAX package's, verbatim.  Negatives come from a
``torch.Generator`` seeded with ``seed``: deterministic per seed, but a
different stream from the JAX package's threefry draws, so the two
evaluators agree statistically, not bitwise.  Fed the same negatives,
:func:`_chunk_metric_sums` agrees with the JAX scorer to float32
round-off.

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) the
evaluation is sharded as the JAX package's ``_sharded_group_eval``: each
chunk's users split over the ranks (the chunk padded to a multiple of the
world size with dummy users that add 0), ``W``, ``H`` and the hash set whole
on every rank, and one all-reduce of the metric sums a call.  Each rank
seeds its negative generator from the seed and its rank (as the JAX form
folds in the axis index), so the draws are statistically equal to one
device's, not bitwise.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
from scipy import sparse

from .. import config
from ..parallel.mesh import current_mesh
from ..ops.hashset import build_pair_hashset, hashset_contains, to_device
from ..utils.profiling import span, spanned, upload
from . import metrics as M
from .recommend import _stable_topk

_TOPK_METRIC_FNS = {
    ("DCG", False): M.dcg_topk_batch,
    ("Recall", False): M.recall_topk_batch,
    ("MAP", False): M.average_precision_topk_batch,
    ("DCG", True): M.dcg_with_ips_topk_batch,
    ("Recall", True): M.recall_with_ips_topk_batch,
    ("MAP", True): M.average_precision_with_ips_topk_batch,
}

NEG_OVERSAMPLE = 2   # candidates drawn per refill round, x num_negatives
MAX_FILL_ROUNDS = 64  # a user whose positives cover the whole catalog has
#                       no valid negative (the reference would spin forever
#                       at evaluator.pyx:106-111); stop and mask the shortfall


def draw_negatives(user_ids: torch.Tensor, hs, generator: torch.Generator,
                   num_items: int, num_negatives: int):
    """Exactly ``num_negatives`` uniform negatives per user: draw, discard
    train/test positives, repeat until every user has enough (duplicates
    allowed, as in the reference's loop, `evaluator.pyx:106-111`).

    Returns ``(neg_items int64[C, num_negatives],
    neg_valid bool[C, num_negatives])``."""
    dev = user_ids.device
    C = user_ids.shape[0]
    R = NEG_OVERSAMPLE * num_negatives
    flat_users = torch.repeat_interleave(user_ids, R)
    neg = torch.zeros((C, num_negatives), dtype=torch.int64, device=dev)
    count = torch.zeros(C, dtype=torch.int64, device=dev)
    rows = torch.arange(C, device=dev)[:, None].expand(C, R)
    for _ in range(MAX_FILL_ROUNDS):
        if not bool(torch.any(count < num_negatives)):
            break
        draws = torch.randint(0, num_items, (C, R), generator=generator,
                              device=dev)
        valid = ~hashset_contains(hs, flat_users,
                                  draws.reshape(-1)).reshape(C, R)
        # destination slot of each valid draw, in draw order; slots past
        # num_negatives (and invalid draws) are dropped
        dest = count[:, None] + torch.cumsum(valid, dim=-1) - 1
        keep = valid & (dest < num_negatives)
        neg[rows[keep], dest[keep]] = draws[keep]
        count = torch.clamp(count + valid.sum(dim=-1), max=num_negatives)
    neg_valid = torch.arange(num_negatives, device=dev)[None, :] \
        < count[:, None]
    return neg, neg_valid


def _chunk_metric_sums(W, H, user_ids, pos_pad, pos_valid, neg_items,
                       neg_valid, props, *, ks: tuple, metric_names: tuple,
                       unbiased: bool) -> torch.Tensor:
    """[n_metrics, n_ks] metric SUMS over one chunk of users.

    Args:
      W: [U, K] user table;  H: [I, K] item table.
      user_ids: int[C] user ids of this chunk.
      pos_pad / pos_valid: [C, P] padded test-positive item ids and mask.
      neg_items / neg_valid: [C, num_negatives] drawn negatives and mask
        (:func:`draw_negatives`).
      props: float[I] per-item propensities.

    Users without test positives contribute 0 (`evaluator.pyx:91-92`).
    """
    C = pos_pad.shape[0]
    num_negatives = neg_items.shape[1]
    cand = torch.cat([pos_pad.long(), neg_items.long()], dim=-1)
    valid = torch.cat([pos_valid, neg_valid], dim=-1)
    labels = torch.cat(
        [pos_valid.to(W.dtype),
         torch.zeros((C, num_negatives), dtype=W.dtype, device=W.device)],
        dim=-1)

    # float32 scores under any param dtype (the JAX package's
    # preferred_element_type): the products of the tables' values exact
    h = H[cand].float()                           # [C, L, K]
    w = W[user_ids.long()].float()                # [C, K]
    scores = torch.bmm(h, w[:, :, None])[:, :, 0]
    scores = torch.where(valid, scores,
                         torch.full_like(scores, -torch.inf))
    kmax = min(max(max(ks), 1), int(cand.shape[-1]))
    top_idx = _stable_topk(scores, kmax)[1]
    labels_top = torch.gather(labels, -1, top_idx)
    # order-invariant denominators over the FULL candidate list
    total_pos = torch.sum(pos_valid, dim=-1).to(W.dtype)
    if unbiased:
        props_top = torch.gather(props[cand], -1, top_idx)
        sn_total = torch.sum(
            torch.where(pos_valid, 1.0 / props[pos_pad.long()],
                        torch.zeros((), dtype=W.dtype, device=W.device)),
            dim=-1)

    out = []
    for name in metric_names:
        fn = _TOPK_METRIC_FNS[(name, unbiased)]
        row = []
        for k in ks:
            row.append(fn(labels_top, props_top, sn_total, k) if unbiased
                       else fn(labels_top, total_pos, k))
        out.append(torch.stack(row))
    return torch.sum(torch.stack(out), dim=-1)   # [n_metrics, n_ks]


class Evaluator:
    """API-compatible rebuild of ``cymf.evaluator.Evaluator``.

    ``evaluate(W, H, seed)`` returns ``{f"{metric}@{k}": float}`` averaged
    over all users of the test matrix.  ``W``/``H`` may be numpy arrays or
    tensors; the work runs on ``device``: by default
    :func:`cymf_tpu_torch.config.default_device`, the card;
    ``device="cpu"`` runs on the CPU.

    A call is a span ``eval.evaluate``
    (:mod:`cymf_tpu_torch.utils.profiling`): ``eval.upload`` (the tables
    to the device), ``eval.state`` (the device state, built by the first
    call) and ``eval.fetch`` (the sums to the host, which waits for the
    card).
    """

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5,
                 num_negatives: int = 100,
                 unbiased: bool = False, device=None):
        X = sparse.csr_matrix(X)
        user_positives = X.copy()
        if X_train is not None:
            user_positives = user_positives + sparse.csr_matrix(X_train)
        X = X.astype(np.float64)
        user_positives = user_positives.astype(np.float64)
        user_positives.sort_indices()
        X.sort_indices()

        self.X = X
        self.user_positives = user_positives
        # per-item mean of the *test* matrix, clipped (evaluator.pyx:50)
        self.propensity_scores = np.maximum(
            np.asarray(X.mean(axis=0)).flatten(), 1e-4)
        self.metrics = list(metrics)
        self.k = k
        self.num_negatives = int(num_negatives)
        self.unbiased = bool(unbiased)
        self._device_arg = device
        self.device = torch.device(device) if device is not None \
            else config.default_device()

        self._user_chunks = self._build_user_chunks(X)
        self._device_state = None

    def _build_user_chunks(self, X, max_chunk: int = 4096,
                           max_elems: int = 1 << 22):
        """Degree-bucketed user chunks (like the ALS chunker): users are
        sorted by test-positive count ascending and grouped so each chunk's
        padded candidate matrix stays bounded — one heavy user no longer
        forces a huge pad onto every chunk.  Chunk user counts round UP to
        a power of two (dummy zero-mask users pad the tail), as in the JAX
        package.  The JAX package then stacks same-shape chunks into one
        ``lax.map`` dispatch; eager PyTorch gains nothing from that, so the
        port scores the chunks one by one."""
        U = X.shape[0]
        deg = np.diff(X.indptr)
        order = np.argsort(deg, kind="stable")
        chunks = []
        start = 0
        while start < U:
            take = 1
            while take < max_chunk and start + take < U:
                pmax = max(int(deg[order[start + take]]), 1)
                P = 1
                while P < pmax:
                    P *= 2
                if (take + 1) * (P + self.num_negatives) > max_elems:
                    break
                take += 1
            sel = order[start:start + take].astype(np.int32)
            start += take
            p2 = 1
            while p2 < take:
                p2 *= 2
            pmax = max(int(deg[sel].max()) if len(sel) else 1, 1)
            P = 1
            while P < pmax:
                P *= 2
            pos_pad = np.zeros((p2, P), np.int32)
            pos_valid = np.zeros((p2, P), bool)
            uids = np.zeros(p2, np.int32)
            uids[:take] = sel
            for r, u in enumerate(sel):
                lo, hi = X.indptr[u], X.indptr[u + 1]
                pos_pad[r, :hi - lo] = X.indices[lo:hi]
                pos_valid[r, :hi - lo] = True
            chunks.append((uids, pos_pad, pos_valid))
        return chunks

    def _to_device(self, mesh):
        """Device-resident evaluation state for ``mesh``: this rank's rows
        of each chunk as tensors (the chunk padded to a multiple of the
        world size), the rejection hash set and the propensities."""
        if self._device_state is None or self._device_state["mesh"] != mesh:
            dev = self.device
            n, p = mesh.num_devices, mesh.rank
            up = self.user_positives.tocoo()

            def rows(a):  # this rank's rows of a chunk padded to n * c
                c = -(-a.shape[0] // n)
                a = np.pad(a, [(0, n * c - a.shape[0])]
                           + [(0, 0)] * (a.ndim - 1))
                return upload(torch.from_numpy(a[p * c:(p + 1) * c]), dev)

            self._device_state = dict(
                mesh=mesh,
                chunks=[tuple(rows(a) for a in ch)
                        for ch in self._user_chunks],
                hs=to_device(build_pair_hashset(up.row, up.col), dev),
                props=upload(torch.as_tensor(self.propensity_scores,
                                             dtype=config.param_dtype()),
                             dev),
            )
        return self._device_state

    @torch.no_grad()
    @spanned("eval.evaluate")
    def evaluate(self, W, H, seed: int = 1234) -> dict:
        ks = ((int(self.k),) if isinstance(self.k, int)
              else tuple(int(k) for k in self.k))
        metric_names = tuple(self.metrics)
        U, I = self.X.shape
        mesh = current_mesh()
        dev = self.device = mesh.resolve_device(self._device_arg)
        with span("eval.upload"):
            Wd = upload(torch.as_tensor(W, dtype=config.param_dtype()), dev)
            Hd = upload(torch.as_tensor(H, dtype=config.param_dtype()), dev)
        with span("eval.state"):
            st = self._to_device(mesh)
        gen = torch.Generator(device=dev)
        # one device: the seed; a rank of a mesh: the seed and the rank
        gen.manual_seed(int(seed) if mesh.num_devices == 1
                        else int(seed) * 1_000_003 + mesh.rank + 1)
        total = None
        for uids, pos_pad, pos_valid in st["chunks"]:
            neg, neg_valid = draw_negatives(uids, st["hs"], gen, I,
                                            self.num_negatives)
            part = _chunk_metric_sums(
                Wd, Hd, uids, pos_pad, pos_valid, neg, neg_valid,
                st["props"], ks=ks, metric_names=metric_names,
                unbiased=self.unbiased)
            total = part if total is None else total + part
        with span("eval.fetch"):
            sums = mesh.all_reduce(total).to("cpu", torch.float64).numpy()

        buff = {}
        for mi, name in enumerate(metric_names):
            for ki, k in enumerate(ks):
                buff[f"{name}@{k}"] = sums[mi, ki] / max(U, 1)
        return buff


class AverageOverAllEvaluator(Evaluator):
    """`evaluator.pyx:141-145`."""

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5, num_negatives: int = 100,
                 device=None):
        super().__init__(X, X_train, metrics, k, num_negatives,
                         unbiased=False, device=device)


AoaEvaluator = AverageOverAllEvaluator


class UnbiasedEvaluator(Evaluator):
    """`evaluator.pyx:147-149`."""

    def __init__(self, X, X_train=None,
                 metrics: Sequence[str] = ("DCG", "Recall", "MAP"),
                 k: Union[int, Sequence[int]] = 5, num_negatives: int = 100,
                 device=None):
        super().__init__(X, X_train, metrics, k, num_negatives, unbiased=True,
                         device=device)
