"""GloVe (Pennington et al. 2014) — PyTorch trainer.

Behavioural spec from `cymf/glove.pyx` + `model.pyx:145-204` +
`optimizer.pyx:85-123`: weighted least squares over co-occurrence counts,

    diff = w_c . h_x + b_c + b_x - log(count)
    f    = min((count / x_max)^alpha, 1)
    L    = 0.5 * f * diff^2

trained with AdaGrad (accumulators initialized to ones) over two
embedding tables and two bias vectors; the final embedding is the average
``(W_central + W_context) / 2`` (`glove.pyx:112`).

Port of `cymf_tpu/models/glove.py` on two single-device ``engine="xla"``
engines.  The packed engine (``_fit_packed_glove``, `ops/glove_epoch.py`)
runs the fused-bias mode: the biases ride as augmented table columns
``[w | b_c | 1] . [h | 1 | b_x]``, one AdaGrad update per sample.  The
portable batch engine (``_fit_batch``, :func:`_glove_epoch`) runs both
bias modes on logical tables through :mod:`cymf_tpu_torch.optim`, dense
or sparse: the fused one (the constant columns masked out of the
gradient), and the reference-exact ``bias_mode="kfold"``, separate
``(V, 1)`` bias columns with K AdaGrad steps a sample in closed form
(:func:`_bias_kfold_update`).  Initialization, the shuffle, the padding
and the per-step sort replay the JAX package's numpy streams, so both
packages train on identical inputs under the same ``np.random.seed``.

``packed="auto"`` follows the JAX rule with the card in the TPU's place
(:meth:`GloVe._packed_engine`): on a CUDA device the packed engine takes
a fused-bias fit of at least 4096 triples with ``num_components <= 124``,
every other fit the batch engine.  The one deliberate difference: on the
CPU ``"auto"`` takes the packed engine at any size (its plain forms are
what the CPU tests hold against the card's kernels), where the JAX
package would take the batch engine.

``engine="pallas"`` runs the sequential small-catalog engine
(``_fit_pallas``, `ops/pallas_engine.py`) on the same augmented tables:
per-sample AdaGrad updates in groups of 8 over the shuffled stream, one
kernel launch an epoch; ``last_loss`` is then the epoch's loss sum, as in
the JAX package.  It implements the fused bias mode only, as in the JAX
package.

Checkpoints hold the JAX package's schema, ``{"Wc", "Wx", "bc", "bx",
"ow", "oh", "abc", "abx"}`` at logical shapes (the packed engine writes
its tables unpacked, the fused mode's unused bias leaves as ``(1, 1)``
placeholders), so the packed and the fused batch engine resume each
other's, of either package; the sequential engine refuses them, as in
the JAX package.

Under a mesh of more than one rank (``cymf_tpu_torch.parallel``) each
engine runs its sharded form (`parallel/shard_step.py`), as the JAX
package's mesh branches do: the packed engine
(``sharded_packed_glove_epoch``: the packed central table row-sharded, the
context table whole on every rank, one all-reduce of its accumulated sums
a step) and the batch engine in either bias mode (``sharded_glove_epoch``,
``sharded_glove_kfold_epoch``: every table row-sharded, the batch padded
to a multiple of the world size and split over the ranks).  The init and
the shuffle come from the ambient numpy state, which ranks need not
share: rank 0 draws them and broadcasts them, so every rank trains the
same stream (the JAX package's one controller draws once).  Checkpoints
are written by rank 0, gathered; a resume takes any row padding.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from scipy import sparse

from .. import config
from ..ops import packed as pk
from ..ops import pallas_engine as pe
from ..ops.glove_epoch import (augment_tables, packed_glove_epoch,
                               prep_glove_shard_static, prep_glove_static,
                               supports_packed_glove)
from ..ops.packed_epoch import PackedAdaGrad, row_dot
from ..ops.segment import dedup_rows
from ..optim import AdaGrad, adagrad_kfold_rows, choose_update_mode
from ..parallel.mesh import current_mesh, fetch_to_host, host_array
from ..parallel.shard_step import (sharded_glove_epoch,
                                   sharded_glove_kfold_epoch,
                                   sharded_packed_glove_epoch)
from ..utils.checkpoint import AsyncCheckpointer, resume_state
from ..utils.profiling import spanned, upload_array
from .base import padded_rows
PAD_CENTRAL = np.int32(2**31 - 1)  # padding sentinel: sorts last, dropped


def _bias_kfold_update(bias, accum, rows, grads, lr: float, k_steps: int,
                       presorted: bool = False) -> None:
    """K consecutive AdaGrad steps with a constant gradient, in closed
    form, on the ``(V, 1)`` columns ``bias`` and ``accum`` IN PLACE: the
    reference emits a sample's bias gradient once per latent dimension
    (`model.pyx:195-204`), so ``delta = -lr * g * sum_{t=1..K}
    rsqrt(a0 + t g^2)`` and ``accum += K g^2`` for each distinct row's
    summed gradient ``g``.  Rows at or past ``V`` are dropped."""
    rows, g = dedup_rows(rows, grads[:, None], bias.shape[0],
                         presorted=presorted)
    adagrad_kfold_rows(bias, accum, rows, g, lr, k_steps)


def _from_rank0(mesh, *arrays) -> list:
    """Rank 0's ``arrays`` on every rank (one broadcast each, the bits
    kept)."""
    return [mesh.broadcast(upload_array(a, mesh.device)).cpu().numpy()
            for a in arrays]


def _gather(v, mesh):
    """The whole table whose row shard on this rank is ``v`` (a dict of
    them: each), on the host: a collective."""
    if isinstance(v, dict):
        return {k: _gather(t, mesh) for k, t in v.items()}
    return fetch_to_host(v, mesh)


def _glove_epoch(Wc, Wx, bc, bx, ow, oh, abc, abx, c_steps, x_steps,
                 n_steps_counts, n_valid, *, optimizer, x_max: float,
                 alpha: float, learning_rate: float, num_components: int,
                 num_central: int, update_mode: str = "dense",
                 bias_mode: str = "fused") -> torch.Tensor:
    """One epoch of the batch engine over ``S`` steps of central ids,
    context ids and counts (``[S, B]`` on the tables' device, each step
    sorted by central id, padding central ids ``2**31 - 1`` last), as
    ``cymf_tpu.models.glove._glove_epoch``.  ``bias_mode``:

    * "fused": ``Wc``/``Wx`` are the ``[V, K + 2]`` augmented tables and
      the bias gradient flows through the same AdaGrad update as the
      embeddings (one update a sample); the constant-one columns are
      masked out of the gradient, so they stay exactly one.  ``bc``,
      ``bx``, ``abc`` and ``abx`` are unused.
    * "kfold": ``Wc``/``Wx`` are ``[V, K]``, the biases ``(V, 1)`` columns
      with their AdaGrad accumulators ``abc``/``abx``, updated by
      :func:`_bias_kfold_update`.

    Updates tables and states IN PLACE; returns the mean loss (0-d
    tensor, ``sum / max(n_valid, 1)``).
    """
    S, B = c_steps.shape
    K = num_components
    nc = Wc.shape[0]
    col = torch.arange(Wc.shape[1], device=Wc.device)
    x_max, alpha = (config.scalar(v, Wc.dtype) for v in (x_max, alpha))
    loss_acc = torch.zeros((), dtype=Wc.dtype, device=Wc.device)
    for t in range(S):
        c, x, cnt = c_steps[t], x_steps[t], n_steps_counts[t]
        # padding triples carry an out-of-range central id: the gathers
        # clamp it, every scatter drops it, the mask zeroes its gradient
        mf = (c < num_central).to(Wc.dtype)
        cc = c.clamp(max=nc - 1)
        wc, hx = Wc.index_select(0, cc), Wx.index_select(0, x)
        f = torch.clamp(torch.pow(cnt / x_max, alpha), max=1.0)
        if bias_mode == "fused":
            diff = row_dot(wc, hx) - torch.log(cnt)
        else:
            diff = (row_dot(wc, hx) + bc.index_select(0, cc)[:, 0]
                    + bx.index_select(0, x)[:, 0] - torch.log(cnt))
        loss = 0.5 * f * torch.square(diff) * mf
        fd = (f * diff * mf)[:, None]
        g_c = fd * hx
        g_x = fd * wc
        if bias_mode == "fused":
            # the constant-1 columns must stay constant
            g_c = g_c * (col != K + 1)
            g_x = g_x * (col != K)
        if update_mode == "dense":
            optimizer.update_dense(Wc, ow, [(c, g_c)])
            optimizer.update_dense(Wx, oh, [(x, g_x)])
        else:
            optimizer.update_rows(Wc, ow, c, g_c)
            optimizer.update_rows(Wx, oh, x, g_x)
        if bias_mode == "kfold":
            _bias_kfold_update(bc, abc, c, fd[:, 0], learning_rate, K,
                               presorted=True)
            _bias_kfold_update(bx, abx, x, fd[:, 0], learning_rate, K)
        loss_acc += torch.sum(loss)
    return loss_acc / config.scalar(float(max(int(n_valid), 1)), Wc.dtype)


class GloVe:
    """API-compatible rebuild of ``cymf.GloVe`` (`glove.pyx:46-75`), on
    ``device``: by default :func:`cymf_tpu_torch.config.default_device`,
    the card; ``device="cpu"`` runs on the CPU."""

    def __init__(self, num_components: int = 50, learning_rate: float = 0.01,
                 alpha: float = 0.75, x_max: float = 10.0,
                 batch_size: int = 4096, update_mode: str = "auto",
                 bias_mode: str = "fused", engine: str = "xla",
                 packed: str = "auto", device=None):
        """Arguments as ``cymf_tpu.GloVe``.  Under ``engine="xla"``,
        ``packed="on"`` runs the packed engine, ``"off"`` the batch
        engine, and ``"auto"`` picks as :meth:`_packed_engine` says.
        ``update_mode`` picks the batch engine's update; it has no effect
        on the packed and sequential engines."""
        self.num_components = int(num_components)
        self.learning_rate = float(learning_rate)
        self.alpha = float(alpha)
        self.x_max = float(x_max)
        self.batch_size = int(batch_size)
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError("update_mode must be auto|dense|sparse")
        self.update_mode = update_mode
        if bias_mode not in ("fused", "kfold"):
            raise ValueError("bias_mode must be fused|kfold")
        self.bias_mode = bias_mode
        if engine not in ("xla", "pallas"):
            raise ValueError("engine must be 'xla' or 'pallas'")
        self.engine = engine
        if packed not in ("auto", "on", "off"):
            raise ValueError("packed must be auto|on|off")
        self.packed = packed
        if bias_mode == "kfold" and engine == "pallas":
            raise NotImplementedError(
                "engine='pallas' implements bias_mode='fused' only (as in "
                "the JAX package)")
        self._device_arg = device
        self.device = torch.device(device) if device is not None \
            else config.default_device()
        self.W = None
        self.bias = None

    def _packed_engine(self, device_type: str, n_samples: int) -> bool:
        """True if the packed engine takes an ``engine="xla"`` fit of
        ``n_samples`` triples: ``packed="on"`` forces it (and raises
        ``ValueError`` for ``bias_mode="kfold"`` or ``num_components >
        124``, which it cannot run), ``"off"`` never takes it; under
        ``"auto"`` a fused-bias fit with ``num_components <= 124`` takes
        it on a CUDA device at 4096 triples or more (the JAX rule,
        `cymf_tpu/models/glove.py:225-237`, with the card in the TPU's
        place) and on the CPU at any size."""
        if self.packed == "off":
            return False
        if self.bias_mode != "fused" \
                or not supports_packed_glove(self.num_components):
            if self.packed == "on":
                raise ValueError(
                    "packed='on' requires bias_mode='fused' and "
                    "num_components <= 124 (the augmented payload K+2 plus "
                    "two decoration lanes must lane-pack)")
            return False
        return self.packed == "on" or device_type != "cuda" \
            or n_samples >= 4096

    @spanned("glove.fit")
    def fit(self, X, num_epochs: int, num_threads: int = 1,
            verbose: bool = False, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train on a sparse co-occurrence matrix (`glove.pyx:75-112`).
        ``num_threads`` is accepted and ignored.  After the fit,
        ``epoch_times_`` holds each epoch's synchronised device seconds;
        the once-per-fit host prep is ``prep_s_``.  ``constant_columns_``
        holds the augmented tables' constant-one columns, for checking
        that they stayed one.  ``checkpoint_path`` persists the tables
        and AdaGrad accumulators every ``checkpoint_every`` epochs;
        ``resume=True`` continues from there (``engine="pallas"``
        refuses checkpoints)."""
        if X is None:
            raise ValueError()
        if not sparse.issparse(X):
            raise TypeError("X must be a type of scipy.sparse.*_matrix.")
        mesh = current_mesh()
        self.device = mesh.resolve_device(self._device_arg)
        n = mesh.num_devices
        K = self.num_components
        t0 = time.perf_counter()
        V1, V2 = X.shape
        # init per glove.pyx:91-94 (no seed: the ambient numpy state)
        W_central = np.random.uniform(-0.5, 0.5, (V1, K)) / K
        central_bias = np.random.uniform(-0.5, 0.5, (V1,)) / K
        W_context = np.random.uniform(-0.5, 0.5, (V2, K)) / K
        context_bias = np.random.uniform(-0.5, 0.5, (V2,)) / K

        # sklearn.utils.shuffle's draw, replayed: one shuffle of an arange
        coo = X.tocoo()
        order = np.arange(coo.nnz)
        np.random.shuffle(order)
        if n > 1:
            W_central, central_bias, W_context, context_bias, order = \
                _from_rank0(mesh, W_central, central_bias, W_context,
                            context_bias, order)
        central = coo.row.astype(np.int32)[order]
        context = coo.col.astype(np.int32)[order]
        counts = coo.data.astype(np.float64)[order]

        N = len(central)
        use_packed = self.engine == "xla" and self._packed_engine(
            self.device.type, N)
        if use_packed:
            B = -(-min(self.batch_size, max(N, 1)) // 1024) * 1024
        else:
            # the batch splits evenly over the ranks
            B = mesh.pad_rows(min(self.batch_size, max(N, n)))
        S = max(1, -(-N // B))
        pad = S * B - N
        if pad:
            central = np.concatenate([central, np.full(pad, PAD_CENTRAL)])
            context = np.concatenate([context, np.zeros(pad, np.int32)])
            counts = np.concatenate([counts, np.ones(pad)])
        if self.engine == "pallas":
            if checkpoint_path is not None:
                raise NotImplementedError(
                    "checkpointing is only supported with engine='xla'")
            self._fit_pallas(W_central, central_bias, W_context,
                             context_bias, central, context, counts, N,
                             num_epochs, verbose, V1, V2, t0)
            return
        # per-step sort by central word (order within a synchronous batch
        # is semantically irrelevant; padding sorts last and is masked)
        c2 = central.reshape(S, B)
        x2 = context.reshape(S, B)
        n2 = counts.reshape(S, B)
        order = np.argsort(c2, axis=1, kind="stable")
        c2 = np.take_along_axis(c2, order, axis=1)
        x2 = np.take_along_axis(x2, order, axis=1)
        n2 = np.take_along_axis(n2, order, axis=1)
        fit = self._fit_packed_glove if use_packed else \
            self._fit_batch_sharded if n > 1 else self._fit_batch
        fit(c2, x2, n2, W_central, central_bias, W_context, context_bias, N,
            num_epochs, verbose, V1, V2, t0, checkpoint_path,
            checkpoint_every, resume)

    def _fit_batch(self, c2, x2, n2, W_central, central_bias, W_context,
                   context_bias, N, num_epochs, verbose, V1, V2, t0,
                   checkpoint_path, checkpoint_every, resume):
        """The portable batch engine (:func:`_glove_epoch`), as the
        single-device branch of ``cymf_tpu.GloVe.fit``: augmented tables
        (fused) or logical tables with ``(V, 1)`` bias columns (kfold),
        AdaGrad accumulators at ones, ``mode`` from ``2 * B`` rows against
        the tables'."""
        dev = self.device
        K = self.num_components
        S, B = c2.shape
        self.packed_engine_ = False

        def table(T):
            T = np.asarray(T)
            if T.ndim == 1:
                T = T[:, None]  # column layout: row-addressed bias updates
            return upload_array(T, dev, config.param_dtype())

        if self.bias_mode == "fused":
            Wc, Wx = (table(T) for T in augment_tables(
                W_central, central_bias, W_context, context_bias))
            bc, bx = table(np.zeros(1)), table(np.zeros(1))  # unused
        else:
            Wc, Wx = table(W_central), table(W_context)
            bc, bx = table(central_bias), table(context_bias)
        opt = AdaGrad(self.learning_rate)
        ow, oh = opt.init(Wc), opt.init(Wx)
        # accumulators start at ones (optimizer.pyx:96-99)
        abc, abx = torch.ones_like(bc), torch.ones_like(bx)

        def state():
            return {"Wc": Wc, "Wx": Wx, "bc": bc, "bx": bx, "ow": ow,
                    "oh": oh, "abc": abc, "abx": abx}

        st, start_epoch = resume_state(checkpoint_path, resume, state(),
                                      self._ckpt_rows(V1, V2))
        Wc, Wx, bc, bx, ow, oh, abc, abx = (st[k] for k in (
            "Wc", "Wx", "bc", "bx", "ow", "oh", "abc", "abx"))
        steps = [upload_array(a, dev) for a in (c2, x2,
                                                n2.astype(np.float32))]
        steps[2] = steps[2].to(config.param_dtype())   # the counts
        self.update_mode_ = choose_update_mode(self.update_mode, 2 * B,
                                               V1 + V2)
        self._run_epochs(num_epochs, verbose, t0, lambda: _glove_epoch(
            Wc, Wx, bc, bx, ow, oh, abc, abx, *steps, N, optimizer=opt,
            x_max=self.x_max, alpha=self.alpha,
            learning_rate=self.learning_rate, num_components=K,
            num_central=V1, update_mode=self.update_mode_,
            bias_mode=self.bias_mode), state, checkpoint_path,
            checkpoint_every, start_epoch)
        Wc, Wx, bc, bx = (host_array(T) for T in (Wc, Wx, bc, bx))
        if self.bias_mode == "kfold":  # the augmented layout, for outputs
            Wc, Wx = augment_tables(Wc, bc[:, 0], Wx, bx[:, 0])
        self._set_outputs(Wc, Wx, K)

    def _ckpt_rows(self, V1: int, V2: int) -> dict:
        """The logical rows of each checkpoint leaf (the fused mode's
        unused bias leaves have one)."""
        b1, b2 = (V1, V2) if self.bias_mode == "kfold" else (1, 1)
        return {"Wc": V1, "Wx": V2, "ow": V1, "oh": V2, "bc": b1, "abc": b1,
                "bx": b2, "abx": b2}

    def _fit_batch_sharded(self, c2, x2, n2, W_central, central_bias,
                           W_context, context_bias, N, num_epochs, verbose,
                           V1, V2, t0, checkpoint_path, checkpoint_every,
                           resume):
        """The batch engine on a mesh, as the mesh branches of
        ``cymf_tpu.GloVe.fit``: every table and AdaGrad state row-sharded
        (rows padded by ``mesh.pad_rows``; the fused mode's unused bias
        leaves stay ``(1, 1)`` on every rank), each central-sorted step
        split into one contiguous slice a rank
        (:func:`~cymf_tpu_torch.parallel.shard_step.sharded_glove_epoch`,
        ``sharded_glove_kfold_epoch``)."""
        mesh = current_mesh()
        n, p, dev = mesh.num_devices, mesh.rank, self.device
        K = self.num_components
        S, B = c2.shape
        Bn = B // n
        V1p, V2p = mesh.pad_rows(V1), mesh.pad_rows(V2)
        self.packed_engine_ = False
        self.update_mode_ = "dense"
        kfold = self.bias_mode == "kfold"

        def table(T, rows):  # the whole padded table, on the host
            T = np.asarray(T)
            # column layout: row-addressed bias updates
            return padded_rows(T[:, None] if T.ndim == 1 else T, rows)

        if kfold:
            Wc, Wx = table(W_central, V1p), table(W_context, V2p)
            bc, bx = table(central_bias, V1p), table(context_bias, V2p)
        else:
            Wc, Wx = (table(T, r) for T, r in zip(augment_tables(
                W_central, central_bias, W_context, context_bias),
                (V1p, V2p)))
            bc = bx = torch.zeros((1, 1),                   # unused
                                  dtype=config.param_dtype())
        opt = AdaGrad(self.learning_rate)
        # accumulators start at ones (optimizer.pyx:96-99)
        like = {"Wc": Wc, "Wx": Wx, "bc": bc, "bx": bx, "ow": opt.init(Wc),
                "oh": opt.init(Wx), "abc": torch.ones_like(bc),
                "abx": torch.ones_like(bx)}
        st, start_epoch = resume_state(checkpoint_path, resume, like,
                                      self._ckpt_rows(V1, V2))
        mesh.agree(start_epoch, "the checkpoint's epoch")
        sharded = {"Wc", "Wx", "ow", "oh"} | (
            {"bc", "bx", "abc", "abx"} if kfold else set())

        def place(k, v):
            if isinstance(v, dict):
                return {j: place(k, t) for j, t in v.items()}
            return mesh.put_table(v) if k in sharded else v.to(dev)

        st = {k: place(k, v) for k, v in st.items()}
        steps = [upload_array(a[:, p * Bn:(p + 1) * Bn], dev)
                 for a in (c2, x2, n2.astype(np.float32))]
        steps[2] = steps[2].to(config.param_dtype())   # the counts
        kw = dict(optimizer=opt, x_max=self.x_max, alpha=self.alpha, K=K,
                  num_central=V1)
        if kfold:
            def run():
                return sharded_glove_kfold_epoch(
                    mesh, *(st[k] for k in ("Wc", "Wx", "bc", "bx", "ow",
                                            "oh", "abc", "abx")),
                    *steps, N, num_central_pad=V1p, **kw)
        else:
            def run():
                return sharded_glove_epoch(mesh, st["Wc"], st["Wx"],
                                           st["ow"], st["oh"], *steps, N,
                                           **kw)
        self._run_epochs(num_epochs, verbose, t0, run, lambda: st,
                         checkpoint_path, checkpoint_every, start_epoch,
                         sharded)
        Wc, Wx, bc, bx = (fetch_to_host(st[k], mesh) for k in (
            "Wc", "Wx", "bc", "bx"))
        Wc, Wx = Wc[:V1], Wx[:V2]
        if kfold:  # the augmented layout, for outputs
            Wc, Wx = augment_tables(Wc, bc[:V1, 0], Wx, bx[:V2, 0])
        self._set_outputs(Wc, Wx, K)

    def _fit_packed_glove(self, c2, x2, n2, W_central, central_bias,
                          W_context, context_bias, N, num_epochs, verbose,
                          V1, V2, t0, checkpoint_path, checkpoint_every,
                          resume):
        """Packed fused engine (`ops/glove_epoch.py`): every stream is
        static per fit, so the prep runs once and each epoch replays it.
        On a mesh (``cymf_tpu.GloVe._fit_packed_glove``'s sharded form):
        this rank's row shard of the packed central table and its AdaGrad
        state (rows padded to ``256 * n``, so a shard is whole windows),
        the whole context table, the rank's contiguous slice of every step
        (``prep_glove_shard_static``), one all-reduce of the context sums
        a step
        (:func:`~cymf_tpu_torch.parallel.shard_step.sharded_packed_glove_epoch`)."""
        mesh = current_mesh()
        n, dev = mesh.num_devices, self.device
        K = self.num_components
        Kp = K + 2
        wrows_w, wrows_h = 256, 256
        mult_w = wrows_w * n
        rw = pk.packed_rows(V1, Kp, multiple=mult_w)
        rh = pk.logical_rows(V2, multiple=wrows_h)
        self.packed_engine_ = True
        if n > 1:
            streams = prep_glove_shard_static(
                c2, x2, n2, V1, K, rw, rh, wrows_w, wrows_h, n, self.x_max,
                self.alpha, shard=mesh.rank)
            # this rank's streams, the shard axis dropped, in the epoch's
            # order (c, x, m, f, l, sx, rowsx, winx, winw)
            streams = [streams[i][0] for i in (0, 1, 2, 3, 4, 6, 7, 8, 5)]
        else:
            m2, f2, l2, winw, sx, rowsx, winx = prep_glove_static(
                c2, x2, n2, V1, K, rw, rh, wrows_w, wrows_h, self.x_max,
                self.alpha)
            streams = [c2, x2, m2, f2, l2, sx, rowsx, winx, winw]

        def put(a):
            return upload_array(a, dev)

        # the central table and its state: this rank's row shard, float32
        # under any param dtype (the kernels' dtype)
        def put_w(a):
            return mesh.put_table(a, torch.float32) if n > 1 else put(a)

        def host_w(T):  # the whole packed central table, on the host
            return fetch_to_host(T, mesh)

        Zc_np, Zx_np = augment_tables(W_central, central_bias, W_context,
                                      context_bias)
        Zc = put_w(pk.pack_array(Zc_np.astype(np.float32), Kp,
                                 multiple=mult_w))
        Zx = put(pk.pack_logical(Zx_np.astype(np.float32), Kp,
                                 multiple=wrows_h))
        opt = PackedAdaGrad(self.learning_rate)
        oc, ox = opt.init(Zc), opt.init(Zx)

        def fused_state():
            # the fused batch engine's schema at logical shapes, so each
            # engine resumes the other's; bc/bx/abc/abx are the fused
            # mode's unused placeholders.  A collective on a mesh
            return {"Wc": pk.unpack_array(host_w(Zc), V1, Kp),
                    "Wx": Zx[:V2, :Kp].cpu().numpy(),
                    "bc": np.zeros((1, 1), np.float32),
                    "bx": np.zeros((1, 1), np.float32),
                    "ow": {"accum": pk.unpack_array(
                        host_w(oc["accum"]), V1, Kp)},
                    "oh": {"accum": ox["accum"][:V2, :Kp].cpu().numpy()},
                    "abc": np.ones((1, 1), np.float32),
                    "abx": np.ones((1, 1), np.float32)}

        st, start_epoch = resume_state(checkpoint_path, resume,
                                      fused_state(), self._ckpt_rows(V1, V2))
        mesh.agree(start_epoch, "the checkpoint's epoch")
        if start_epoch:
            ones_w = pk.pack_array(np.ones((V1, Kp), np.float32), Kp,
                                   multiple=mult_w) > 0
            ones_h = pk.pack_logical(np.ones((V2, Kp), np.float32), Kp,
                                     multiple=wrows_h) > 0
            Zc = put_w(pk.pack_array(st["Wc"], Kp, multiple=mult_w))
            Zx = put(pk.pack_logical(st["Wx"], Kp, multiple=wrows_h))
            # off-payload accumulator lanes must be ONES (the
            # initializer): a zero accumulator with a zero gradient is
            # 0 * rsqrt(0) = NaN on lanes the kernels never read
            oc = {"accum": put_w(np.where(ones_w, pk.pack_array(
                st["ow"]["accum"], Kp, multiple=mult_w), 1.0).astype(
                    np.float32))}
            ox = {"accum": put(np.where(ones_h, pk.pack_logical(
                st["oh"]["accum"], Kp, multiple=wrows_h), 1.0).astype(
                    np.float32))}
        dev_streams = [put(a) for a in streams]
        kw = dict(lr=self.learning_rate, K=K, rw=rw, rh=rh, wrows_w=wrows_w,
                  wrows_h=wrows_h)
        if n > 1:
            def run():
                return sharded_packed_glove_epoch(mesh, Zc, Zx, oc, ox,
                                                  *dev_streams, N, **kw)
        else:
            def run():
                return packed_glove_epoch(Zc, Zx, oc, ox, *dev_streams, N,
                                          **kw)
        self._run_epochs(num_epochs, verbose, t0, run, fused_state,
                         checkpoint_path, checkpoint_every, start_epoch)
        Zc_log = pk.unpack_array(host_w(Zc), V1, Kp)
        Zx_log = Zx[:V2, :Kp].cpu().numpy()
        self._set_outputs(Zc_log, Zx_log, K)

    def _fit_pallas(self, W_central, central_bias, W_context, context_bias,
                    central, context, counts, N, num_epochs, verbose, V1, V2,
                    t0, chunk: int = 4096, group: int = 8):
        """Sequential per-triple training (`ops/pallas_engine.py`), as
        ``cymf_tpu.GloVe._fit_pallas``: the padded stream re-chunked, the
        keep mask, ``f`` and ``log(count)`` computed once on the host."""
        K = self.num_components
        if K + 2 > 126 or not pe.fits_vmem(V1 + V2, "adagrad"):
            raise ValueError(
                "vocab/table size exceeds the sequential engine's budget "
                "(the JAX package's VMEM gate); use engine='xla'")
        dev = self.device
        Np = len(central)             # padded to S * B by fit; re-chunk
        chunk = max(group, (min(chunk, Np) // group) * group)
        S = max(1, -(-Np // chunk))
        pad = S * chunk - Np
        central = np.concatenate([central, np.full(pad, PAD_CENTRAL)])
        context = np.concatenate([context, np.zeros(pad, np.int32)])
        counts = np.concatenate([counts, np.ones(pad)])
        keep = (central != PAD_CENTRAL) & (central < V1) \
            & (np.arange(len(central)) < N)
        f = np.minimum((counts / self.x_max) ** self.alpha, 1.0)
        logcnt = np.log(np.maximum(counts, 1e-30))

        def put(a, dtype):
            return upload_array(a.astype(dtype).reshape(S, 1, chunk), dev)

        Zc_np, Zx_np = augment_tables(W_central, central_bias, W_context,
                                      context_bias)
        Zc = pe.pack_table(Zc_np, "adagrad", dev)
        Zx = pe.pack_table(Zx_np, "adagrad", dev)
        # a masked sample reads row 0 and writes nothing
        streams = [put(np.where(keep, central, 0), np.int32),
                   put(context, np.int32), put(f, np.float32),
                   put(logcnt, np.float32), put(keep, np.int32)]
        self._run_epochs(num_epochs, verbose, t0, lambda: (
            pe.glove_pallas_epoch(Zc, Zx, *streams, lr=self.learning_rate,
                                  k_dim=K, group=group)[2]))
        self.packed_engine_ = False
        Zc_log = Zc[:V1, :K + 2].cpu().numpy()
        Zx_log = Zx[:V2, :K + 2].cpu().numpy()
        self._set_outputs(Zc_log, Zx_log, K)

    def _run_epochs(self, num_epochs, verbose, t0, run, state_fn=None,
                    checkpoint_path=None, checkpoint_every=1,
                    start_epoch=0, sharded=frozenset()):
        """Every engine's epoch loop: ``prep_s_`` (the host work since
        ``t0``, the card synchronised), then a call of ``run()`` (an
        epoch; it returns the loss) for each epoch from ``start_epoch``
        to ``num_epochs - 1``, each timed into ``epoch_times_``;
        ``last_loss`` from the last.  With ``checkpoint_path``,
        ``state_fn()`` is saved after every ``checkpoint_every``-th epoch
        (the copy to the host blocks, ``checkpoint_s_``; the write runs on
        a thread and is flushed before this returns).  On a mesh every
        rank calls ``state_fn()`` (which may gather) and the leaves under
        the keys ``sharded``, this rank's row shards, are gathered; rank 0
        writes the file, which is whole before any rank returns."""
        mesh = current_mesh()
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prep_s_ = time.perf_counter() - t0
        self.epoch_times_ = []
        self.checkpoint_s_ = []
        ckpt = AsyncCheckpointer() if checkpoint_path else None
        loss = None
        for it in range(start_epoch, num_epochs):
            t1 = time.perf_counter()
            loss = run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(time.perf_counter() - t1)
            if verbose:
                print(f"ITER={it + 1:{len(str(num_epochs))}}, "
                      f"LOSS: {float(loss):.4f}", flush=True)
            if ckpt and (it + 1) % checkpoint_every == 0:
                t1 = time.perf_counter()
                state = {k: _gather(v, mesh) if k in sharded else v
                         for k, v in state_fn().items()}
                if mesh.rank == 0:
                    ckpt.save(checkpoint_path, state, it)
                self.checkpoint_s_.append(time.perf_counter() - t1)
        if ckpt:
            ckpt.wait()
            mesh.barrier()
        self.last_loss = float(loss) if loss is not None else None

    def _set_outputs(self, Zc_log, Zx_log, K):
        """The learned tables from the augmented ones (``[rows, K + 2]``)."""
        self.W_central = Zc_log[:, :K].astype(np.float64)
        self.bias = Zc_log[:, K].astype(np.float64)
        self.W_context = Zx_log[:, :K].astype(np.float64)
        self.context_bias = Zx_log[:, K + 1].astype(np.float64)
        # the constant-one columns, for checking that they stayed one
        self.constant_columns_ = (Zc_log[:, K + 1], Zx_log[:, K])
        self.W = (self.W_central + self.W_context) / 2.0  # glove.pyx:112

    def save_word2vec_format(self, path, index2word):
        """gensim-compatible word2vec text export (`glove.pyx:164-177`)."""
        output = Path(path)
        with output.open("w") as f:
            f.write(f"{self.W.shape[0]} {self.W.shape[1]}\n")
            for i in range(self.W.shape[0]):
                f.write(f"{index2word[i]} "
                        + " ".join(map(str, self.W[i])) + "\n")
