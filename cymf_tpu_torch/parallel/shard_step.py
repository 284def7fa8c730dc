"""The sharded epochs and chunk solves: one rank per device, explicit
collectives.

Port of `cymf_tpu/parallel/shard_step.py`.  The JAX package writes each
epoch as a ``shard_map`` over N devices of one controller; here every rank
calls the same function on its own shard and tensors, and the
``psum``/``all_gather``/``psum_scatter`` become ``torch.distributed``
collectives on the mesh's group (:class:`~.mesh.MeshContext`).  Every rank
must make every call, in the same order.

Two partitions.  The fused engines keep one table row-sharded and the
other whole:

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
* :func:`sharded_packed_glove_epoch` (``:752-848``): the same partition
  for GloVe's packed augmented central table, one all-reduce of the
  context side's ``(rh, 128)`` a step, the step body
  ``ops/glove_epoch.py::glove_step``.

The batch engines and the ALS solves, plain PyTorch as in the JAX
package, row-shard both tables and split the batch (or a chunk's rows)
over the ranks; rows travel by an O(batch) exchange (:func:`_resolve`:
each owner contributes the rows it owns, a reduce-scatter hands each rank
its samples' rows), gradients or solutions come back by ``all_gather``
and each owner writes the rows it owns:

* :func:`sharded_bpr_epoch` (``:63-148``), :func:`sharded_relmf_epoch`
  (``:151-243``), :func:`sharded_glove_epoch` (fused bias, ``:321-392``)
  and :func:`sharded_glove_kfold_epoch` (``:514-631``): one dense masked
  update of each shard a step.
* :func:`sharded_wmf_chunk` (``:245-319``) and
  :func:`sharded_expomf_chunk` (``:394-513``): each rank solves its
  ``C / n`` rows of a chunk (``ops/als.py::place_mesh_chunks``); ExpoMF's
  exposure block is split by the other side's rows and its ``[C, K, K]``
  Gramian partials are reduce-scattered onto the solving rank.

Each epoch sums its loss on the rank and all-reduces it once at the end
(the JAX forms ``psum`` it every step: the same sum up to float order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.als import (get_solver, weighted_gramian, wmf_solve_rows,
                       woodbury_core)
from ..ops.glove_epoch import glove_freeze_masks, glove_step
from ..ops.hashset import hashset_contains
from ..ops.packed_epoch import (PackedAdaGrad, bpr_v4_step, live_negatives,
                                make_packed_optimizer)
from ..ops.segment import csr_lookup, dedup_rows
from ..ops.wide_epoch import wide_step
from ..optim import adagrad_kfold_rows, set_rows


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


def _resolve(mesh, pairs) -> tuple:
    """For each ``(table, idx_all)`` of ``pairs`` (this rank's row shard of
    a table, the global ids of a whole batch of ``n * m`` rows, the same
    on every rank), this rank's ``m`` rows of ``table[idx_all]``: every
    rank contributes the rows it owns and one reduce-scatter of the
    contributions, side by side, sums them."""
    p = mesh.rank
    parts = [_resolve_rows(T, idx, T.shape[0], p) for T, idx in pairs]
    got = mesh.reduce_scatter(parts[0] if len(parts) == 1
                              else torch.cat(parts, dim=1))
    return got.split([T.shape[1] for T, _ in pairs], dim=1)


def rows_everywhere(mesh, T, rows) -> torch.Tensor:
    """The rows ``rows`` (global ids, the same on every rank) of the
    row-sharded table whose shard here is ``T``, on every rank: each owner
    contributes its rows, one all-reduce sums them; ids no rank owns give
    zeros."""
    return mesh.all_reduce(_resolve_rows(T, rows, T.shape[0], mesh.rank))


def _write_owned(mesh, T, rows, x_all) -> None:
    """``T[row] = x_all[c]`` for each ``rows[c]`` this rank owns (``T`` its
    row shard); the others are dropped, as the JAX ``mode="drop"``
    scatter drops them."""
    lidx = rows - mesh.rank * T.shape[0]
    keep = (lidx >= 0) & (lidx < T.shape[0])
    set_rows(T, lidx.clamp(0, T.shape[0] - 1), x_all, keep)


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


@torch.no_grad()
def sharded_relmf_epoch(mesh, W, H, opt_w, opt_h, label_src, props, gen, *,
                        optimizer, weight_decay: float, clip_value: float,
                        num_users: int, num_items: int, num_steps: int,
                        batch_size: int, binary: bool,
                        draw) -> torch.Tensor:
    """One epoch of RelMF's batch engine on this rank (``:151-243``):
    ``W``/``H`` and their optimizer states the rank's row shards of the
    tables padded by ``mesh.pad_rows`` (updated IN PLACE), ``label_src``
    the pair hash set (``binary``) or ``X``'s CSR, ``props`` the ``(I, 1)``
    propensities, both whole on every rank.  Each step draws the whole
    batch of ``batch_size`` cells (a multiple of the world size) with
    ``draw(gen, B, num_users, num_items, device)``, so the cell stream is
    the single-device engine's, and works on its slice ``[p B/n,
    (p+1) B/n)``.  Returns the SUM of the per-sample losses, the same on
    every rank (the caller normalizes, as ``models.relmf._relmf_epoch``'s
    do)."""
    n, p = mesh.num_devices, mesh.rank
    B, Bn, K = batch_size, batch_size // mesh.num_devices, W.shape[1]
    rpd_u, rpd_i = W.shape[0], H.shape[0]
    dev = W.device
    wd, M = weight_decay, clip_value
    loss_acc = torch.zeros((), dtype=W.dtype, device=dev)
    for _ in range(num_steps):
        # every rank holds the whole draw: no gather of the indices
        u_all, i_all = draw(gen, B, num_users, num_items, dev)
        u, i = u_all[p * Bn:(p + 1) * Bn], i_all[p * Bn:(p + 1) * Bn]
        if binary:
            r = hashset_contains(label_src, u, i).to(W.dtype)
        else:
            r = csr_lookup(*label_src, u, i)[1]
        w = (r / torch.clamp(props.index_select(0, i)[:, 0], min=M))[:, None]
        wu, hi = _resolve(mesh, [(W, u_all), (H, i_all)])

        # the gradient work on the rank's B / n cells (model.pyx:130-139)
        s = torch.sum(wu * hi, dim=1, keepdim=True)
        g_w = -(w * (1.0 - s) * hi + (1.0 - w) * (0.0 - s) * hi) + wd * wu
        g_h = -(w * (1.0 - s) * wu + (1.0 - w) * (0.0 - s) * wu) + wd * hi
        l2 = (torch.sum(torch.square(wu), dim=1)
              + torch.sum(torch.square(hi), dim=1))
        loss_acc += torch.sum(w[:, 0] * torch.square(1.0 - s[:, 0])
                              + (1.0 - w[:, 0]) * torch.square(s[:, 0])
                              + wd * l2)

        g_all = mesh.all_gather(torch.cat([g_w, g_h], dim=1))
        optimizer.update_dense(W, opt_w, [(_owned_rows(u_all, rpd_u, p),
                                           g_all[:, :K])])
        optimizer.update_dense(H, opt_h, [(_owned_rows(i_all, rpd_i, p),
                                           g_all[:, K:])])
    return mesh.all_reduce(loss_acc)


@torch.no_grad()
def sharded_glove_epoch(mesh, Wc, Wx, ow, oh, c_steps, x_steps, n_steps,
                        n_valid: int, *, optimizer, x_max: float,
                        alpha: float, K: int,
                        num_central: int) -> torch.Tensor:
    """One epoch of GloVe's batch engine, fused biases (``:321-392``), on
    this rank: ``Wc``/``Wx`` the rank's row shards of the augmented
    tables ``[w | b_c | 1]``/``[h | 1 | b_x]`` padded by ``mesh.pad_rows``,
    ``ow``/``oh`` their AdaGrad states (all updated IN PLACE);
    ``c_steps``/``x_steps``/``n_steps`` ``[S, B / n]`` the rank's contiguous
    slice of each central-sorted step.  Returns the mean loss, the same
    on every rank."""
    p = mesh.rank
    rpd_c, rpd_x = Wc.shape[0], Wx.shape[0]
    width = Wc.shape[1]
    col = torch.arange(width, device=Wc.device)
    loss_acc = torch.zeros((), dtype=Wc.dtype, device=Wc.device)
    for t in range(c_steps.shape[0]):
        c, x, cnt = c_steps[t], x_steps[t], n_steps[t]
        mf = (c < num_central).to(Wc.dtype)
        c_all, x_all = mesh.all_gather(torch.stack([c, x], dim=1)).unbind(1)
        wc, hx = _resolve(mesh, [(Wc, c_all), (Wx, x_all)])
        f = torch.clamp(torch.pow(cnt / x_max, alpha), max=1.0)
        diff = torch.sum(wc * hx, dim=1) - torch.log(cnt)
        loss_acc += torch.sum(0.5 * f * torch.square(diff) * mf)
        fd = (f * diff * mf)[:, None]
        # the constant-1 columns must stay constant
        g_all = mesh.all_gather(torch.cat([fd * hx * (col != K + 1),
                                           fd * wc * (col != K)], dim=1))
        optimizer.update_dense(Wc, ow, [(_owned_rows(c_all, rpd_c, p),
                                         g_all[:, :width])])
        optimizer.update_dense(Wx, oh, [(_owned_rows(x_all, rpd_x, p),
                                         g_all[:, width:])])
    return _epoch_loss(mesh, loss_acc, n_valid)


@torch.no_grad()
def sharded_glove_kfold_epoch(mesh, Wc, Wx, bc, bx, ow, oh, abc, abx,
                              c_steps, x_steps, n_steps, n_valid: int, *,
                              optimizer, x_max: float, alpha: float, K: int,
                              num_central: int, num_central_pad: int
                              ) -> torch.Tensor:
    """One epoch of GloVe's batch engine with the reference-exact kfold
    bias rule (``:514-631``) on this rank: ``Wc``/``Wx`` ``[V / n, K]`` and
    the ``(V / n, 1)`` bias columns ``bc``/``bx`` with their accumulators
    ``abc``/``abx`` the rank's row shards (updated IN PLACE); the steps as
    :func:`sharded_glove_epoch`'s.  The biases' dedup runs on the whole
    gathered step on every rank alike, over ``num_central_pad`` rows (the
    padded central table's), so each distinct row's summed gradient is the
    single-device engine's; each rank then applies the closed form to the
    rows it owns.  Returns the mean loss, the same on every rank."""
    p = mesh.rank
    rpd_c, rpd_x = Wc.shape[0], Wx.shape[0]
    lr = optimizer.learning_rate
    loss_acc = torch.zeros((), dtype=Wc.dtype, device=Wc.device)
    for t in range(c_steps.shape[0]):
        c, x, cnt = c_steps[t], x_steps[t], n_steps[t]
        mf = (c < num_central).to(Wc.dtype)
        c_all, x_all = mesh.all_gather(torch.stack([c, x], dim=1)).unbind(1)
        wc, bcv, hx, bxv = _resolve(mesh, [(Wc, c_all), (bc, c_all),
                                           (Wx, x_all), (bx, x_all)])
        f = torch.clamp(torch.pow(cnt / x_max, alpha), max=1.0)
        diff = (torch.sum(wc * hx, dim=1) + bcv[:, 0] + bxv[:, 0]
                - torch.log(cnt))
        loss_acc += torch.sum(0.5 * f * torch.square(diff) * mf)
        fd = (f * diff * mf)[:, None]
        g_all = mesh.all_gather(torch.cat([fd * hx, fd * wc, fd], dim=1))
        optimizer.update_dense(Wc, ow, [(_owned_rows(c_all, rpd_c, p),
                                         g_all[:, :K])])
        optimizer.update_dense(Wx, oh, [(_owned_rows(x_all, rpd_x, p),
                                         g_all[:, K:2 * K])])
        # the host sorts each step by central id and the ranks' slices
        # are contiguous, so the gathered central stream is sorted
        for bias, accum, rows, rpd, pre in (
                (bc, abc, c_all, rpd_c, True),
                (bx, abx, x_all, rpd_x, False)):
            rows_d, g_d = dedup_rows(rows, g_all[:, 2 * K:],
                                     num_central_pad, presorted=pre)
            adagrad_kfold_rows(bias, accum, _owned_rows(rows_d, rpd, p),
                               g_d, lr, K)
    return _epoch_loss(mesh, loss_acc, n_valid)


@torch.no_grad()
def sharded_packed_glove_epoch(mesh, Zc, Zx, oc, ox, c_steps, x_steps,
                               m_steps, f_steps, l_steps, sx_steps,
                               rowsx_steps, winx, winw, n_valid: int, *,
                               lr: float, K: int, rw: int, rh: int,
                               wrows_w: int = 256,
                               wrows_h: int = 256) -> torch.Tensor:
    """One packed GloVe epoch on this rank's shard (``:752-848``): ``Zc``/
    ``oc`` the rank's ``(rw / n, 128)`` rows of the packed augmented central
    table and its AdaGrad state, ``Zx``/``ox`` the whole logical context
    table, all updated IN PLACE; the streams this rank's
    (``ops/glove_epoch.py::prep_glove_shard_static`` with ``shard=rank``,
    the shard axis dropped), in
    :func:`~cymf_tpu_torch.ops.glove_epoch.packed_glove_epoch`'s order.  The
    central gather, the sample kernel (#8), the central accumulation (#2)
    and its AdaGrad pass are local; the context accumulation (#2) runs
    over the whole catalog and one all-reduce of its ``(rh, 128)`` sums a
    step merges the ranks' before the context update.  Returns the mean
    loss, the same on every rank."""
    rw_l = rw // mesh.num_devices
    if Zc.shape[0] != rw_l:
        raise ValueError(f"Zc has {Zc.shape[0]} rows, expected the shard's "
                         f"{rw_l} of {rw}")
    opt = PackedAdaGrad(lr)
    freeze_c, freeze_x = glove_freeze_masks(K, Zc.device)
    loss = torch.zeros((), dtype=torch.float32, device=Zc.device)
    for t in range(c_steps.shape[0]):
        loss += glove_step(
            Zc, Zx, oc, ox, opt, c_steps[t], x_steps[t], m_steps[t],
            f_steps[t], l_steps[t], sx_steps[t], rowsx_steps[t], winx[t, 0],
            winx[t, 1], winw[t, 0], winw[t, 1], K=K, rw=rw_l, rh=rh,
            wrows_w=wrows_w, wrows_h=wrows_h, freeze_c=freeze_c,
            freeze_x=freeze_x, reduce_x=mesh.all_reduce)
    return _epoch_loss(mesh, loss, n_valid)


def sharded_gramian(mesh, Y, weight_decay: float) -> torch.Tensor:
    """``Y^T Y + wd I`` of a row-sharded ``Y``: the local product,
    all-reduced, the same on every rank (``:282-285``)."""
    eye = torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device)
    return mesh.all_reduce(Y.T @ Y) + weight_decay * eye


@torch.no_grad()
def sharded_wmf_chunk(mesh, Y, T, A0, A0inv, chunk, *, weight: float,
                      solver: str, wb_max_p: int = 0) -> None:
    """One WMF chunk (``:245-319``): this rank solves its ``C / n`` rows of
    ``chunk`` (``ops/als.py::place_mesh_chunks``) and writes the rows of
    ``T`` it owns, IN PLACE.  ``Y``/``T`` are the rank's row shards of the
    source and target tables; ``A0`` the half-sweep's :func:`sharded_gramian`
    and ``A0inv`` its inverse (or None: no chunk takes the Woodbury form).
    The chunk's positives come through :func:`_resolve` (an all-gather of
    its ``C x P`` ids, a reduce-scatter of ``C x P x K`` rows), the solutions
    by an all-gather of ``C x K``.  A chunk with ``P <= wb_max_p`` and
    ``weight > 1`` solves by the Woodbury form; ``solver`` is the resolved
    name (``ops/als.py::resolve_chol_solver``, once a fit)."""
    Cn, P = chunk.idx_pad.shape
    sub, = _resolve(mesh, [(Y, mesh.all_gather(chunk.idx_pad.reshape(-1)))])
    sub = sub.reshape(Cn, P, -1) * chunk.valid[..., None].to(Y.dtype)
    if P <= wb_max_p and weight > 1.0:
        x = woodbury_core(sub, A0inv, chunk.valid, weight, solver)
    else:
        x = wmf_solve_rows(sub, A0, chunk.valid, weight, solver)
    _write_owned(mesh, T, chunk.rows, mesh.all_gather(x))


@torch.no_grad()
def sharded_expomf_chunk(mesh, E_src, E_other, Y, mu_term, T, chunk, *,
                         lam_y: float, ridge, prefactor: float, solver: str,
                         mu_axis: str, num_real_rows: int,
                         num_real_cols: int) -> torch.Tensor:
    """One ExpoMF E+M chunk (``:394-513``) on this rank.  ``E_src``,
    ``E_other``, ``Y`` and ``T`` are the rank's row shards of this side's
    epoch-start table, the other side's epoch-start table (whose rows are
    the exposure's columns), the other side's table of the normal
    equations and this side's target, which gets the rows it owns IN
    PLACE.  The exposure block is split by the other side's rows: the rank
    forms ``E [C, rows of E_other]`` for every row of the chunk and the
    exposure-weighted Gramian's ``[C, K, K]`` partials over its columns,
    which a reduce-scatter sums onto the rank that solves each row.
    ``mu_term`` is ``(1 - mu) / mu``: this rank's ``[rows of E_other]``
    under ``mu_axis="col"`` (the user sweep), the chunk's ``[C]`` on every
    rank under ``"row"`` (the item sweep).  ``ridge`` is
    ``(wd / lam_y) I``.  Returns ``e_colsum``, the exposure summed over the
    chunk's real rows, for this rank's columns (the mu update's
    operand)."""
    if mu_axis not in ("col", "row"):
        raise ValueError("mu_axis must be 'col' or 'row'")
    p = mesh.rank
    rpd_o = E_other.shape[0]
    C = chunk.rows.shape[0]
    Cn, P = chunk.idx_pad.shape
    # 1. the chunk rows' epoch-start factors on every rank (O(C K))
    w_rows = rows_everywhere(mesh, E_src, chunk.rows)
    # 2. this rank's E block [C, rows of E_other] (expomf.pyx:134-137)
    S = w_rows @ E_other.T
    nn = prefactor * torch.exp(-lam_y * S.square() / 2.0)
    mu_b = mu_term[None, :] if mu_axis == "col" else mu_term[:, None]
    post = (nn + 1e-8) / (nn + 1e-8 + mu_b)
    # observed cells -> exposure 1, on this rank's columns; the pads go
    # to -1, owned by no rank
    idx_all = mesh.all_gather(torch.where(chunk.valid, chunk.idx_pad, -1))
    lcol = idx_all - p * rpd_o
    obs_idx = torch.where((lcol >= 0) & (lcol < rpd_o), lcol, rpd_o).long()
    obs = torch.zeros((C, rpd_o + 1), dtype=torch.bool,
                      device=S.device).scatter_(1, obs_idx, True)
    E = torch.where(obs[:, :rpd_o], 1.0, post)
    cols = torch.arange(rpd_o, device=E.device) + p * rpd_o
    E = E * (cols < num_real_cols).to(E.dtype)[None, :]
    e_colsum = (E * (chunk.rows < num_real_rows).to(E.dtype)[:, None]).sum(0)
    # 3. the Gramian partials of every chunk row over this rank's columns,
    # summed onto the rank that solves the row
    A = mesh.reduce_scatter(lam_y * weighted_gramian(E, Y)) + ridge
    # 4. b over the observed rows (E = 1 there, expomf.pyx:188-191)
    sub, = _resolve(mesh, [(Y, idx_all.reshape(-1))])
    b = lam_y * sub.reshape(Cn, P, -1).sum(dim=1)
    x = get_solver(solver)(A, b)
    x = torch.where(chunk.valid.any(dim=1, keepdim=True), x, 0.0)
    _write_owned(mesh, T, chunk.rows, mesh.all_gather(x))
    return e_colsum
