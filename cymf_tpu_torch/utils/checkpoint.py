"""Checkpoint / resume for trainer state.  Port of
`cymf_tpu/utils/checkpoint.py`, in its file format.

A checkpoint is one ``.npz`` holding a flattened nested dict: embedding
tables, optimizer state (Adam moments, AdaGrad accumulators) and the
epoch counter, enough to resume a killed ``fit`` where it left off.  The
keys are the ``/``-joined dict keys (``"W"``, ``"ow/m"``, ``"owp/v"``),
``__epoch__`` an int64 and ``__meta__/<name>`` each meta entry, so a file
either package writes loads in the other.

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
    cannot reach (``.cpu()`` of a CPU tensor would share its memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


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


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``like`` (the same nested
    dict).

    Returns ``(state, epoch, meta)``.  A tensor leaf of ``like`` comes
    back as a tensor on its device and of its dtype; any other leaf as
    the stored array.  A missing leaf raises ``KeyError``, a leaf of
    another shape ``ValueError``.
    """
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    epoch = int(flat.pop(_EPOCH_KEY, -1))
    meta = {k[len(_META_PREFIX):]: flat.pop(k)
            for k in list(flat) if k.startswith(_META_PREFIX)}

    leaves = {}
    for key, leaf in _leaves(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        like_shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else tuple(np.shape(leaf))
        if tuple(arr.shape) != like_shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                f"expected {like_shape} — written by a different "
                "schema/mesh padding.  Engines that support cross-layout "
                "resume (BPR) convert through their own raw-load path; "
                "this loader requires exact shapes so drift fails loudly.")
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, dtype=leaf.dtype).to(leaf.device)
        leaves[key] = arr
    return _rebuild(like, leaves), epoch, meta


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
    if not (resume and path is not None and os.path.exists(path)):
        return like, 0
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    epoch = int(flat.pop(_EPOCH_KEY, -1))
    leaves = {}
    for key, leaf in _leaves(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, shape = flat[key], tuple(leaf.shape)
        if arr.shape != shape:
            n = (rows or {}).get(key.split("/")[0], -1)
            if arr.shape[1:] != shape[1:] or min(arr.shape[0],
                                                 shape[0]) < n or n < 0:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {arr.shape}, "
                    f"expected {shape} or another row count of at least "
                    f"{n}")
            out = _to_host(leaf)
            out[:n] = arr[:n]
            arr = out
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, dtype=leaf.dtype).to(leaf.device)
        leaves[key] = arr
    return _rebuild(like, leaves), epoch + 1
