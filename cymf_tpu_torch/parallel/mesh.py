"""Process group and row-sharding layout of the port's multi-device paths.

Port of `cymf_tpu/parallel/mesh.py` on ``torch.distributed``.  The JAX
package runs one controller over N devices (``shard_map``); it also has a
multi-process form, where every process runs the same fit
(``initialize_distributed``, ``fetch_to_host``).  PyTorch's idiom is that
second form, so the port takes it: one process (a *rank*) per device, every
rank running the same ``fit`` on its own device, NCCL between CUDA devices
and gloo between CPU processes.

* **Embedding tables** (``W``: users x K) are *row-sharded*: rank ``p``
  holds rows ``[p * rpd, (p + 1) * rpd)`` of a table padded to a multiple
  of the world size (:meth:`MeshContext.pad_rows`,
  :meth:`MeshContext.put_table`).
* **Replicated** state (the packed engine's item table, the evaluator's
  tables) is a whole copy on every rank (:meth:`MeshContext.put_replicated`),
  kept equal by running the same update on the same all-reduced inputs.
* The collectives are explicit (``all_reduce``, ``all_gather``,
  ``reduce_scatter``) and every rank must call each one, in the same
  order.

The JAX ``NamedSharding`` methods (``table()``, ``batch2d()``, ...) have no
counterpart: a rank holds plain tensors, its own shard or a whole copy, and
the placement is the arrays it is given.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config

ROW_AXIS = "d"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id`` (``dist.init_process_group`` with a ``tcp://`` init
    method at ``coordinator_address``, ``"host:port"``); NCCL where CUDA is
    available, else gloo.  Does nothing when ``coordinator_address`` is
    None, as in the JAX package, so it is safe to call unconditionally.
    Under ``torchrun`` call ``dist.init_process_group()`` instead (it reads
    the launcher's variables)."""
    if coordinator_address is None:
        return
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo", init_method=init,
        world_size=num_processes, rank=process_id)


@dataclass(frozen=True)
class MeshContext:
    """A 1-D world of ranks, one device each: this rank's place in it.

    ``group`` is the process group (None: a world of one, where every
    collective is the identity), ``rank`` this process's index in it,
    ``num_devices`` the world size and ``device`` this rank's device."""

    group: Any
    rank: int
    num_devices: int
    device: torch.device

    @classmethod
    def create(cls, device=None) -> "MeshContext":
        """The default process group's world if one is initialised,
        otherwise a world of one.  ``device`` defaults to
        :func:`cymf_tpu_torch.config.default_device`, the card, or under
        NCCL to ``cuda:<LOCAL_RANK mod cards>``."""
        group = dist.group.WORLD if dist.is_available() \
            and dist.is_initialized() else None
        if group is None:
            dev = torch.device(device) if device is not None \
                else config.default_device()
            return cls(None, 0, 1, dev)
        rank = dist.get_rank(group)
        if device is not None:
            dev = torch.device(device)
        elif dist.get_backend(group) == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        else:
            dev = config.default_device()
        return cls(group, rank, dist.get_world_size(group), dev)

    def resolve_device(self, device) -> torch.device:
        """Where work given ``device`` (None: the default) runs: in a world
        of one, ``device`` or :func:`cymf_tpu_torch.config.default_device`;
        under more ranks, this rank's device, and another ``device``
        raises ``ValueError``."""
        if self.num_devices == 1:
            return torch.device(device) if device is not None \
                else config.default_device()
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"device {device} is not this rank's mesh "
                             f"device {self.device}")
        return self.device

    @property
    def local_ranks(self) -> int:
        """Ranks on this host: ``LOCAL_WORLD_SIZE`` (set by ``torchrun``),
        else the whole world."""
        return int(os.environ.get("LOCAL_WORLD_SIZE", self.num_devices))

    # -- layout ----------------------------------------------------------------
    def pad_rows(self, n: int) -> int:
        """Rows are padded to a multiple of the world size so row-sharding is
        even.  Models allocate tables with ``pad_rows(num_rows)`` rows and
        expose only the first ``num_rows`` to users."""
        d = self.num_devices
        return ((n + d - 1) // d) * d

    def put_table(self, x, dtype=None) -> torch.Tensor:
        """This rank's row shard ``[rank * rpd, (rank + 1) * rpd)`` of the
        whole table ``x`` (rows a multiple of the world size) as a tensor
        on this rank's device, in ``dtype`` (by default
        :func:`cymf_tpu_torch.config.param_dtype`; the fused engines,
        whose kernels take float32 under any param dtype, pass
        ``torch.float32``)."""
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        if x.shape[0] % self.num_devices:
            raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                             f"{self.num_devices} ranks (pad_rows first)")
        rpd = x.shape[0] // self.num_devices
        return x[self.rank * rpd:(self.rank + 1) * rpd].to(
            self.device, dtype or config.param_dtype(), copy=True)

    def put_replicated(self, x) -> torch.Tensor:
        """The whole of ``x`` as a tensor on this rank's device, in
        :func:`cymf_tpu_torch.config.param_dtype`."""
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(self.device, config.param_dtype(), copy=True)

    # -- collectives (every rank calls each, in the same order) ---------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sums ``t`` over the ranks IN PLACE; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 0, in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.num_devices)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (``n * m`` rows) summed over the ranks; this rank's ``m``
        rows of the sum."""
        if self.group is None:
            return t
        parts = list(t.chunk(self.num_devices))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, [p.contiguous() for p in parts],
                            group=self.group)
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, IN PLACE (every rank passes a
        tensor of the same shape and dtype); returns it."""
        if self.group is not None:
            dist.broadcast(t, dist.get_global_rank(self.group, 0),
                           group=self.group)
        return t

    def broadcast_float(self, x: float) -> float:
        """Rank 0's ``x`` on every rank: a control-flow decision taken on
        it comes out the same everywhere."""
        if self.group is None:
            return x
        return float(self.broadcast(torch.tensor(
            [x], dtype=torch.float64, device=self.device)).item())

    def agree(self, x: int, what: str) -> int:
        """``x``, which every rank must hold the same: raises
        ``ValueError`` on every rank (not on some, which would leave the
        others waiting in their next collective) if any differs."""
        if self.group is None:
            return x
        t = torch.tensor([x, -x], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        if int(t[0]) != -int(t[1]):
            raise ValueError(f"the ranks disagree on {what}: from "
                             f"{-int(t[1])} to {int(t[0])}")
        return x

    def barrier(self) -> None:
        """Every rank's host waits for all: an all-reduce of one value on
        this rank's device, read back (``dist.barrier`` would guess the
        NCCL device)."""
        if self.group is not None:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=self.group)
            t.item()


def host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that later in-place updates of the tensor
    cannot reach.  numpy has no bfloat16: a bfloat16 (or float16) tensor
    comes back as a float32 array with the same values, where the JAX
    package returns an ``ml_dtypes`` array."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.to("cpu", torch.float32).numpy()
    return t.to("cpu", copy=True).numpy()


def fetch_to_host(x, mesh: Optional[MeshContext] = None) -> np.ndarray:
    """numpy copy of the row-sharded table whose shard on this rank is
    ``x``: the ranks' even row shards all-gathered in rank order, the whole
    table on every rank, as the JAX form's ``process_allgather``.  A
    collective under a world of more than one rank (``mesh``, by default
    :func:`current_mesh`): every rank calls it together.  A copy that later
    in-place updates of ``x`` cannot reach (:func:`host_array`: a bfloat16
    table comes back as float32)."""
    mesh = mesh if mesh is not None else current_mesh()
    if not torch.is_tensor(x):
        return np.array(x)
    if mesh.num_devices == 1:
        return host_array(x)
    return host_array(mesh.all_gather(x.detach()))


_local = threading.local()


def current_mesh() -> MeshContext:
    """The ambient MeshContext: the one :func:`use_mesh` set on this
    thread, else :meth:`MeshContext.create`'s default (the default process
    group's world, or a world of one)."""
    ctx = getattr(_local, "ctx", None)
    return ctx if ctx is not None else MeshContext.create()


@contextlib.contextmanager
def use_mesh(ctx: MeshContext):
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev
