"""Checkpoint / resume for trainer state.  Port of
`cymf_tpu/utils/checkpoint.py`, in its file format.

A checkpoint is one ``.npz`` holding a flattened nested dict: embedding
tables, optimizer state (Adam moments, AdaGrad accumulators) and the
epoch counter, enough to resume a killed ``fit`` where it left off.  The
keys are the ``/``-joined dict keys (``"W"``, ``"ow/m"``, ``"owp/v"``),
``__epoch__`` an int64 and ``__meta__/<name>`` each meta entry, so a file
either package writes loads in the other.

Under ``config.set_param_dtype(torch.bfloat16)`` a bfloat16 leaf is
written as the JAX package writes its ``ml_dtypes`` arrays: the 2-byte bit
patterns as a void ``V2`` entry, which numpy cannot cast.  Such a file does
not resume, in either package: loading it raises ``ValueError``
(:func:`check_leaves`), as the JAX package's ``astype`` does.

:class:`AsyncCheckpointer` overlaps the disk write with training: the
device-to-host copy happens before ``save`` returns (the consistency
point: the engines update their tables in place, so the snapshot must be
taken before the next epoch's work is queued), then the npz write and the
atomic rename run on a background thread.  The trainers use it;
``wait()`` flushes at the end of ``fit``.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..parallel.mesh import host_array

_EPOCH_KEY = "__epoch__"
_META_PREFIX = "__meta__/"


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` of a nested dict, keys ``/``-joined and sorted at
    each level (the order of ``jax.tree_util``'s dict flattening); an
    empty dict (sgd's optimizer state) has no leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates of the tensor
    cannot reach (``.cpu()`` of a CPU tensor would share its memory); a
    bfloat16 tensor as its bit patterns, a ``V2`` array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def check_leaves(flat: Dict[str, np.ndarray]) -> None:
    """Raise ``ValueError`` if a leaf of a loaded checkpoint is a void
    entry: the ``V2`` bit patterns of a bfloat16 table, which numpy (and
    the JAX package's resume) cannot cast to a number."""
    for key, arr in flat.items():
        if arr.dtype.kind == "V":
            raise ValueError(
                f"checkpoint leaf {key!r} holds {arr.dtype.str} entries (the "
                "bit patterns of a bfloat16 table), which cannot be cast: a "
                "checkpoint written under a bfloat16 param dtype does not "
                "resume, as in the JAX package")


def _flatten(state: Any, epoch: int,
             meta: Dict[str, Any] | None) -> Dict[str, np.ndarray]:
    flat = {k: _to_host(v) for k, v in _leaves(state)}
    flat[_EPOCH_KEY] = np.asarray(epoch, np.int64)
    for k, v in (meta or {}).items():
        flat[_META_PREFIX + k] = np.asarray(v)
    return flat


def save_checkpoint(path: str, state: Any, epoch: int,
                    meta: Dict[str, Any] | None = None) -> None:
    """Atomically write ``state`` (a nested dict of tensors or arrays) and
    ``epoch`` to ``path``."""
    _write_atomic(path, _flatten(state, epoch, meta))


def _write_atomic(path: str, flat: Dict[str, np.ndarray]) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class AsyncCheckpointer:
    """Background checkpoint writer.

    ``save()`` blocks only for the device-to-host copy (consistency) and
    for any still-running previous write (so at most one write is in
    flight and the atomic renames land in save order); the npz write and
    the rename run on a daemon thread.  Call ``wait()`` before reading
    the file or returning from ``fit``.  An exception of the background
    write re-raises on the next ``save()``/``wait()``.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, state: Any, epoch: int,
             meta: Dict[str, Any] | None = None) -> None:
        self._join()
        flat = _flatten(state, epoch, meta)

        def run() -> None:
            try:
                _write_atomic(path, flat)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        self._join()


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _fill(like: Any, flat: Dict[str, np.ndarray],
          rows: Dict[str, int] | None = None) -> Any:
    """The structure of ``like`` with each leaf read from ``flat``: a
    tensor leaf of ``like`` as a tensor on its device and of its dtype,
    any other leaf as the stored array.  ``rows`` as in
    :func:`resume_state`; any other shape difference raises
    ``ValueError``, a missing leaf ``KeyError``."""
    leaves = {}
    for key, leaf in _leaves(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, shape = flat[key], tuple(np.shape(leaf))
        if arr.shape != shape:
            n = (rows or {}).get(key.split("/")[0], -1)
            if arr.shape[1:] != shape[1:] or min(arr.shape[0],
                                                 shape[0]) < n or n < 0:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"expected {shape}"
                    + (f" or another row count of at least {n}" if n >= 0
                       else "")
                    + " — written by another schema or row padding")
            out = host_array(leaf) if isinstance(leaf, torch.Tensor) \
                else np.array(leaf)
            out[:n] = arr[:n]
            arr = out
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, dtype=leaf.dtype).to(leaf.device)
        leaves[key] = arr
    return _rebuild(like, leaves)


def _read(path: str) -> Tuple[Dict[str, np.ndarray], int, Dict[str, Any]]:
    """The one read of a checkpoint file: ``(leaves, epoch, meta)``, the
    flat leaves with ``__epoch__`` and the meta entries taken out;
    a bfloat16 leaf raises ``ValueError`` (:func:`check_leaves`)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    check_leaves(flat)
    epoch = int(flat.pop(_EPOCH_KEY, -1))
    meta = {k[len(_META_PREFIX):]: flat.pop(k)
            for k in list(flat) if k.startswith(_META_PREFIX)}
    return flat, epoch, meta


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``like`` (the same nested
    dict).

    Returns ``(state, epoch, meta)``.  A tensor leaf of ``like`` comes
    back as a tensor on its device and of its dtype; any other leaf as
    the stored array.  A missing leaf raises ``KeyError``, a leaf of
    another shape or a bfloat16 leaf (:func:`check_leaves`)
    ``ValueError``.
    """
    flat, epoch, meta = _read(path)
    return _fill(like, flat), epoch, meta


def resume_point(path: str | None, resume: bool
                 ) -> Tuple[Dict[str, np.ndarray] | None, int]:
    """Where a fit starts: ``(leaves, start_epoch)``, the flat leaves of
    the checkpoint at ``path`` (:func:`_read`) and the epoch after the
    saved one when ``resume`` is on and the file exists, else ``(None,
    0)``."""
    if not (resume and path is not None and os.path.exists(path)):
        return None, 0
    flat, epoch, _ = _read(path)
    return flat, epoch + 1


def resume_state(path: str | None, resume: bool, like: Any,
                 rows: Dict[str, int] | None = None) -> Tuple[Any, int]:
    """Where a fit starts: ``(state, start_epoch)``, the checkpoint at
    ``path`` loaded into the structure of ``like`` and the epoch after the
    saved one when ``resume`` is on and the file exists, else ``(like,
    0)``.  ``rows`` takes a checkpoint written under another row padding
    (another number of ranks, or the JAX package's mesh, whose tables are
    padded to a multiple of its device count): a leaf under the top-level
    key ``k`` whose shape differs from ``like``'s in its row count alone
    has its first ``rows[k]`` rows (the logical rows) copied into a copy
    of ``like``'s leaf, whose other rows keep their values.  Any other
    difference raises ``ValueError``, a missing leaf ``KeyError``.  A
    tensor leaf of ``like`` comes back as a tensor on its device and of its
    dtype, any other leaf as an array."""
    flat, start_epoch = resume_point(path, resume)
    if flat is None:
        return like, 0
    return _fill(like, flat, rows), start_epoch
