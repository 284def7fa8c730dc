"""The sharded BPR epochs: one rank per device, explicit collectives.

Port of the BPR half of `cymf_tpu/parallel/shard_step.py`.  The JAX
package writes each epoch as a ``shard_map`` over N devices of one
controller; here every rank calls the same function on its own shard and
tensors, and the ``psum``/``all_gather``/``psum_scatter`` become
``torch.distributed`` collectives on the mesh's group
(:class:`~.mesh.MeshContext`).  Every rank must make every call, in the
same order.

* :func:`sharded_packed_bpr_epoch` (``shard_step.py:632-749``): the packed
  W table is row-sharded and each step's user-sorted stream splits into
  one contiguous slice per shard (``ops/packed_epoch.py::
  prep_shard_static``), so the W gather, the fused sample kernel, the W
  accumulation and the W optimizer pass are local.  The logical H table
  is replicated: each rank accumulates its slice's item-side sums ``D``
  ``(rh, 128)`` over the whole catalog, one all-reduce merges them, and the
  H pass runs on every rank on the same sums.  The step body is the
  single-device engine's (``ops/packed_epoch.py::bpr_v4_step``).
* :func:`sharded_wide_bpr_epoch` (``:849-973``): the same partition for
  K >= 128, one all-reduce of ``(rh, Kp + 128)`` a step, the step body
  ``ops/wide_epoch.py::wide_step``.
* :func:`sharded_bpr_epoch` (``:63-148``): the batch engine's form, plain
  PyTorch as in the JAX package.  Both tables are row-sharded and the
  batch is split over the ranks; rows travel by an O(batch) exchange
  (``all_gather`` of the indices, each owner resolves its rows, a
  reduce-scatter hands each rank its samples' rows), gradients come back
  by ``all_gather`` and each owner makes one dense masked update of its
  shard.

Each epoch sums its loss on the rank and all-reduces it once at the end
(the JAX forms ``psum`` it every step: the same sum up to float order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.packed_epoch import bpr_v4_step, live_negatives, \
    make_packed_optimizer
from ..ops.wide_epoch import wide_step


def _epoch_loss(mesh, loss: torch.Tensor, n_valid: int) -> torch.Tensor:
    return mesh.all_reduce(loss) / max(int(n_valid), 1)


@torch.no_grad()
def sharded_packed_bpr_epoch(mesh, Wp, Hp, ow, oh, u_steps, i_steps,
                             si_steps, rowsi_steps, wini, j_steps,
                             mask_steps, sj_steps, rowsj_steps, winj, winw,
                             n_valid: int, *, opt_name: str, lr: float,
                             weight_decay: float, K: int, rw: int, rh: int,
                             wrows_w: int = 256,
                             wrows_h: int = 256) -> torch.Tensor:
    """One v4 epoch on this rank's shard.  ``Wp``/``ow`` are the rank's
    ``(rw / n, 128)`` row shard of the packed user table and its optimizer
    state, ``Hp``/``oh`` the whole logical item table, all updated IN
    PLACE.  The streams are this rank's (``prep_shard_static`` /
    ``prep_shard_epoch`` with ``shard=rank``, the shard axis dropped), laid
    out as :func:`~cymf_tpu_torch.ops.packed_epoch.packed_bpr_epoch`'s with
    the per-shard batch ``Bd``.  ``n_valid`` is the whole epoch's sample
    count; returns the mean loss, the same on every rank."""
    rw_l = rw // mesh.num_devices
    if Wp.shape[0] != rw_l:
        raise ValueError(f"Wp has {Wp.shape[0]} rows, expected the shard's "
                         f"{rw_l} of {rw}")
    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=Wp.device)
    for t in range(u_steps.shape[0]):
        loss += bpr_v4_step(
            Wp, Hp, ow, oh, opt, u_steps[t], i_steps[t], si_steps[t],
            rowsi_steps[t], wini[t, 0], wini[t, 1], j_steps[t],
            mask_steps[t].to(torch.float32), sj_steps[t], rowsj_steps[t],
            winj[t, 0], winj[t, 1], winw[t, 0], winw[t, 1],
            weight_decay=weight_decay, K=K, rw=rw_l, rh=rh, wrows_w=wrows_w,
            wrows_h=wrows_h, reduce_h=mesh.all_reduce)
    return _epoch_loss(mesh, loss, n_valid)


@torch.no_grad()
def sharded_wide_bpr_epoch(mesh, W, H, ow, oh, u_steps, i_steps,
                           rowsu_steps, winw, si_steps, rowsi_steps, wini,
                           j_steps, mask_steps, sj_steps, rowsj_steps, winj,
                           mi_steps, mj_steps, n_valid: int, *,
                           opt_name: str, lr: float, weight_decay: float,
                           K: int, rw: int, rh: int,
                           wrows: int = 512) -> torch.Tensor:
    """One wide epoch (K >= 128) on this rank's shard: ``W``/``ow`` the
    rank's ``(rw / n, Kp)`` rows, ``H``/``oh`` the whole ``(rh, Kp)`` item
    table, updated IN PLACE; the streams this rank's
    (``prep_shard_static_wide``, ``prep_shard_epoch`` and
    ``wide_shard_masks`` at ``shard=rank``), in
    :func:`~cymf_tpu_torch.ops.wide_epoch.wide_bpr_epoch`'s order.  Returns
    the mean loss, the same on every rank."""
    rw_l = rw // mesh.num_devices
    if W.shape[0] != rw_l:
        raise ValueError(f"W has {W.shape[0]} rows, expected the shard's "
                         f"{rw_l} of {rw}")
    opt = make_packed_optimizer(opt_name, lr)
    loss = torch.zeros((), dtype=torch.float32, device=W.device)
    for t in range(u_steps.shape[0]):
        loss += wide_step(
            W, H, ow, oh, opt, u_steps[t], i_steps[t], rowsu_steps[t],
            winw[t, 0], winw[t, 1], si_steps[t], rowsi_steps[t], wini[t, 0],
            wini[t, 1], j_steps[t], mask_steps[t], sj_steps[t],
            rowsj_steps[t], winj[t, 0], winj[t, 1], mi_steps[t], mj_steps[t],
            weight_decay=weight_decay, K=K, rw=rw_l, rh=rh, wrows=wrows,
            reduce_h=mesh.all_reduce)
    return _epoch_loss(mesh, loss, n_valid)


def _resolve_rows(table, idx_all, rpd: int, rank: int) -> torch.Tensor:
    """This rank's contribution to the rows ``idx_all`` (global ids, the
    whole batch): its own rows, zeros for the others'."""
    lidx = idx_all - rank * rpd
    owned = (lidx >= 0) & (lidx < rpd)
    return torch.where(owned[:, None],
                       table.index_select(0, lidx.clamp(0, rpd - 1)), 0.0)


def _owned_rows(idx_all, rpd: int, rank: int) -> torch.Tensor:
    """Local row of each owned global id, the drop sentinel ``rpd`` for
    the rest."""
    lidx = idx_all - rank * rpd
    return torch.where((lidx >= 0) & (lidx < rpd), lidx, rpd)


@torch.no_grad()
def sharded_bpr_epoch(mesh, W, H, opt_w, opt_h, u_steps, i_steps, hs,
                      n_valid: int, gen, *, optimizer, weight_decay: float,
                      num_users: int, num_items: int,
                      draw) -> torch.Tensor:
    """One epoch of the batch engine on this rank: ``W``/``H`` and their
    optimizer states are the rank's row shards of the tables padded by
    ``mesh.pad_rows`` (updated IN PLACE), ``u_steps``/``i_steps`` int32
    ``[S, B / n]`` the rank's slice of each sorted step, ``hs`` the whole
    pair hash set.  Each step draws the whole batch's negatives from
    ``gen`` with ``draw(gen, B, num_items, device)`` and takes its slice,
    so the stream equals the single-device engine's.  Returns the mean
    loss, the same on every rank."""
    n, p = mesh.num_devices, mesh.rank
    S, Bn = u_steps.shape
    K = W.shape[1]
    rpd_u, rpd_i = W.shape[0], H.shape[0]
    dev = W.device
    wd = weight_decay
    loss_acc = torch.zeros((), dtype=W.dtype, device=dev)
    for t in range(S):
        u, i = u_steps[t], i_steps[t]
        j = draw(gen, Bn * n, num_items, dev)[p * Bn:(p + 1) * Bn]
        mf = live_negatives(hs, u, j, num_users).to(W.dtype)[:, None]
        u_all, i_all, j_all = mesh.all_gather(
            torch.stack([u, i, j], dim=1)).unbind(1)
        wu, hi, hj = mesh.reduce_scatter(torch.cat(
            [_resolve_rows(W, u_all, rpd_u, p),
             _resolve_rows(H, i_all, rpd_i, p),
             _resolve_rows(H, j_all, rpd_i, p)], dim=1)).split(K, dim=1)

        # the gradient work on the rank's B / n samples (model.pyx:81-83)
        x = torch.sum(wu * (hi - hj), dim=1, keepdim=True)
        sig = torch.sigmoid(-x)
        g_wu = -(sig * (hi - hj) - wd * wu) * mf
        g_hi = -(sig * wu - wd * hi) * mf
        g_hj = -(-sig * wu - wd * hj) * mf
        l2 = (torch.sum(torch.square(wu), dim=1)
              + torch.sum(torch.square(hi), dim=1)
              + torch.sum(torch.square(hj), dim=1))
        loss_acc += torch.sum((-F.logsigmoid(x[:, 0]) + wd * l2) * mf[:, 0])

        # the return path: each owner accumulates the rows it owns
        g_all = mesh.all_gather(torch.cat([g_wu, g_hi, g_hj], dim=1))
        optimizer.update_dense(W, opt_w, [(_owned_rows(u_all, rpd_u, p),
                                           g_all[:, :K])])
        optimizer.update_dense(H, opt_h, [
            (_owned_rows(i_all, rpd_i, p), g_all[:, K:2 * K]),
            (_owned_rows(j_all, rpd_i, p), g_all[:, 2 * K:])])
    return _epoch_loss(mesh, loss_acc, n_valid)
