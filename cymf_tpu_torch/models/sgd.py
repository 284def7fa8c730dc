"""The once-a-fit set-up that BPR's and RelMF's SGD engines share.

- :func:`positive_keys`: the sorted keys of a fit's positives, which the
  host prep's rejection filter and the sequential engine's lookups read;
- :func:`pair_hashset`: the pair hash set on the tables' device, which
  the batch engines and device prep test membership against;
- :func:`epoch_generator`: the draw stream of one epoch on the device;
- :class:`Layout`: a table format, the tables and optimizer states laid
  out in it, placed on the device or sharded over a mesh, resumed from a
  checkpoint of any format, and published under its checkpoint leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import packed as pk
from ..ops.hashset import build_pair_hashset, to_device
from ..ops.packed_epoch import unpack_device
from ..ops.wide_epoch import pack_wide
from ..parallel.mesh import host_array
from ..utils.checkpoint import resume_point
from ..utils.profiling import upload_array


def positive_keys(X) -> np.ndarray:
    """The keys ``u * num_items + i`` of ``X``'s entries, int64, one a
    stored entry (duplicates kept), ascending.  ``X`` is a CSR from
    :func:`~cymf_tpu_torch.models.base.as_csr`, which sorts the indices of
    each row: the keys come out ascending with no sort."""
    U, I = X.shape
    users = np.repeat(np.arange(U, dtype=np.int64), np.diff(X.indptr))
    return users * I + X.indices


def pair_hashset(X, device):
    """The hash set of ``X``'s (user, item) pairs (`ops/hashset.py`) on
    ``device`` (``h2d_bytes``)."""
    coo = X.tocoo()
    return to_device(build_pair_hashset(coo.row, coo.col), device)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The device draw stream of one epoch: a ``torch.Generator`` on
    ``device`` seeded from ``(seed, epoch)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        (int(seed), int(epoch), 7)).generate_state(1)[0]))
    return gen


# each format's checkpoint leaves of the optimizer states, (W's, H's): the
# JAX package's schema; every format stores the tables as logical rows,
# "W" and "H"
LEAVES = {"logical": ("ow", "oh"), "packed": ("owp", "ohp"),
          "wide": ("oww", "ohw")}


def _logical(prefix: str, a: np.ndarray, K: int) -> np.ndarray:
    """A leaf of the format whose leaves are ``prefix``'s, as logical
    rows: the packed W's slots unfolded, the lane padding dropped."""
    if prefix == "owp":
        return a[:, :pk.num_slots(K) * K].reshape(-1, K)
    if prefix in ("ohp", "oww", "ohw"):
        return a[:, :K]
    return a


class Layout:
    """One table format of the SGD engines, for ``U`` users, ``I`` items
    and ``K`` components:

    - ``"logical"`` (the batch engines): ``(rows, K)`` tables in
      :func:`~cymf_tpu_torch.config.param_dtype`, the optimizers of
      :mod:`cymf_tpu_torch.optim`, leaves ``ow``/``oh``;
    - ``"packed"`` (K <= 127): W packed, several logical rows to a
      128-lane row (`ops/packed.py::pack_array`), H one row to a 128-lane
      row (``pack_logical``), float32, leaves ``owp``/``ohp``;
    - ``"wide"`` (K >= 128): ``(rows, Kp)`` tables
      (`ops/wide_epoch.py::pack_wide`), float32, leaves ``oww``/``ohw``.

    W's rows are padded to a multiple of ``rows_w``, H's to one of
    ``rows_h``.  A side that ``shard`` marks is this rank's row shard of
    the table and its states (``mesh.put_table``: its rows a multiple of
    the world size); the other is whole on the fit's device."""

    def __init__(self, kind: str, U: int, I: int, K: int, rows_w: int = 1,
                 rows_h: int = 1, shard=(False, False)):
        self.kind, self.K = kind, int(K)
        self.rows, self.multiple = (U, I), (rows_w, rows_h)
        self.shard = tuple(shard)
        self.leaves = LEAVES[kind]
        self.dtype = config.param_dtype() if kind == "logical" \
            else torch.float32

    def pack(self, side: int, a) -> np.ndarray:
        """The first logical rows of ``a`` (W's for ``side`` 0, H's for 1)
        as this format's host array, padded rows zero."""
        n, m = self.rows[side], self.multiple[side]
        a = np.asarray(a)[:n]
        if self.kind == "packed":
            fn = pk.pack_array if side == 0 else pk.pack_logical
            return fn(a, self.K, multiple=m)
        if self.kind == "wide":
            return pack_wide(a, self.K, multiple=m)
        if n % m:
            return np.concatenate([a, np.zeros((-n % m, self.K), a.dtype)])
        return a

    def restore(self, flat, side: int, template) -> dict:
        """One side's optimizer state from the leaves ``flat`` of a
        checkpoint of any format, at any row padding, as host arrays:
        this format's own leaves as they are where their shapes match,
        else each leaf made logical (:func:`_logical`) and laid out again
        on the payload, every other lane and row keeping ``template``'s
        value (the initial state: AdaGrad's ones on a packed table's count
        and dead lanes, or on a mesh's padding rows)."""
        own = self.leaves[side]
        prefixes = [own] + [v[side] for v in LEAVES.values()
                            if v[side] != own]
        mask = self.pack(side, np.ones((self.rows[side], self.K),
                                       np.float32)) > 0
        out = {}
        for sub, t in template.items():
            t = host_array(t)
            keys = [f"{p}/{sub}" for p in prefixes]
            key = next((k for k in keys if k in flat), None)
            if key is None:
                raise KeyError(f"checkpoint has none of {keys} — not a "
                               "checkpoint of this model and optimizer")
            a = np.asarray(flat[key])
            if key == keys[0] and a.shape == t.shape:
                out[sub] = a
                continue
            # a row count alone may differ (another device count's
            # padding); any other difference is another layout or version
            if key == keys[0] and (a.ndim != t.ndim
                                   or a.shape[1:] != t.shape[1:]):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {a.shape}, "
                    f"expected {t.shape} — written by an incompatible "
                    "layout/version")
            src = key.split("/")[0]
            out[sub] = np.where(mask, self.pack(side, _logical(
                src, a, self.K)), t)
        return out

    def state(self, model, opt, checkpoint_path, resume: bool):
        """Once a fit: ``(W, H, ow, oh, start_epoch)``, the tables and
        ``opt``'s states laid out and placed, and the epoch the fit starts
        at.  From the checkpoint at ``checkpoint_path`` where ``resume``
        finds one (:func:`~cymf_tpu_torch.utils.checkpoint.resume_point`),
        the epoch after the saved one, which the ranks must agree on; else
        from ``model.W``/``model.H`` and ``opt``'s initial states at epoch
        0.  Every copy to the device counts as ``h2d_bytes``.  The fit's
        :meth:`publish` publishes these tensors."""
        flat, start_epoch = resume_point(checkpoint_path, resume)
        model.mesh.agree(start_epoch, "the checkpoint's epoch")
        tables, states = [], []
        for side, T in enumerate((model.W, model.H) if flat is None
                                 else (flat["W"], flat["H"])):
            host = self.pack(side, T)
            tables.append(self._place(model, side, host))
            if flat is None:
                states.append(opt.init(tables[-1]))
                continue
            init = opt.init(torch.as_tensor(host, dtype=self.dtype))
            states.append({k: self._place(model, side, v) for k, v in
                           self.restore(flat, side, init).items()})
        self._live = (model, *tables, *states)
        return (*tables, *states, start_epoch)

    def _place(self, model, side: int, a) -> torch.Tensor:
        """The host array ``a`` on the device, in the format's dtype: this
        rank's row shard where ``shard`` marks the side, else whole on
        ``model.device``."""
        if self.shard[side]:
            return model.mesh.put_table(
                torch.as_tensor(a, dtype=self.dtype), self.dtype)
        return upload_array(a, model.device, self.dtype)

    def publish(self) -> None:
        """Set the live state of the model :meth:`state` set up: the
        tables at logical width under ``"W"`` and ``"H"`` (views of the
        laid-out tables), the states under this format's leaves, and the
        sharded sides' keys."""
        model, W, H, ow, oh = self._live
        if self.kind == "packed":
            W, H = unpack_device(W, self.K), H[:, :self.K]
        elif self.kind == "wide":
            W, H = W[:, :self.K], H[:, :self.K]
        model._state = {"W": W, "H": H, self.leaves[0]: ow,
                        self.leaves[1]: oh}
        w, h = ("W", self.leaves[0]), ("H", self.leaves[1])
        model._sharded_keys = frozenset((w if self.shard[0] else ())
                                        + (h if self.shard[1] else ()))
