"""GloVe (Pennington et al. 2014) — PyTorch trainer.

Behavioural spec from `cymf/glove.pyx` + `model.pyx:145-204` +
`optimizer.pyx:85-123`: weighted least squares over co-occurrence counts,

    diff = w_c . h_x + b_c + b_x - log(count)
    f    = min((count / x_max)^alpha, 1)
    L    = 0.5 * f * diff^2

trained with AdaGrad (accumulators initialized to ones) over two
embedding tables and two bias vectors; the final embedding is the average
``(W_central + W_context) / 2`` (`glove.pyx:112`).

Port of `cymf_tpu/models/glove.py` on its single-device packed engine
(``_fit_packed_glove``, `ops/glove_epoch.py`) in the fused-bias mode: the
biases ride as augmented table columns ``[w | b_c | 1] . [h | 1 | b_x]``,
one AdaGrad update per sample.  Initialization, the shuffle, the padding
and the per-step sort replay the JAX package's numpy streams, so both
packages train on identical inputs under the same ``np.random.seed``.

``engine="pallas"`` runs the sequential small-catalog engine
(``_fit_pallas``, `ops/pallas_engine.py`) on the same augmented tables:
per-sample AdaGrad updates in groups of 8 over the shuffled stream, one
kernel launch an epoch; ``last_loss`` is then the epoch's loss sum, as in
the JAX package.

Not ported yet (ROADMAP.md, queue 1): the in-jit engine
(``packed="off"`` and ``num_components > 124`` under ``engine="xla"``),
the reference-exact ``bias_mode="kfold"`` (which ``engine="pallas"``
refuses in the JAX package too), checkpoints, ``read_text`` and the
co-occurrence builders.  Each option raises ``NotImplementedError``.  The
port trains on one device; the JAX package's sharded packed engine has no
counterpart yet.
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
                               prep_glove_static, supports_packed_glove)
from ..ops.packed_epoch import PackedAdaGrad

_LATER = "is not ported to cymf_tpu_torch yet (ROADMAP.md, queue 1)"
PAD_CENTRAL = np.int32(2**31 - 1)  # padding sentinel: sorts last, dropped


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
        ``packed="auto"`` and ``"on"`` both run the packed engine, the only
        XLA engine ported; ``update_mode`` is validated and has no effect on
        either engine."""
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
        if bias_mode == "kfold":
            raise NotImplementedError(f"bias_mode='kfold' {_LATER}")
        if engine == "xla" and packed == "off":
            raise NotImplementedError(f"packed='off' (the in-jit engine) "
                                      f"{_LATER}")
        self.device = torch.device(device) if device is not None \
            else config.default_device()
        self.W = None
        self.bias = None

    def fit(self, X, num_epochs: int, num_threads: int = 1,
            verbose: bool = False, checkpoint_path=None,
            checkpoint_every: int = 1, resume: bool = False):
        """Train on a sparse co-occurrence matrix (`glove.pyx:75-112`).
        ``num_threads`` is accepted and ignored.  After the fit,
        ``epoch_times_`` holds each epoch's synchronised device seconds;
        the once-per-fit host prep is ``prep_s_``.  ``constant_columns_``
        holds the augmented tables' constant-one columns, for checking
        that they stayed one."""
        if X is None:
            raise ValueError()
        if not sparse.issparse(X):
            raise TypeError("X must be a type of scipy.sparse.*_matrix.")
        if checkpoint_path is not None or resume:
            raise NotImplementedError(f"checkpoints {_LATER}")
        K = self.num_components
        if self.engine == "xla" and not supports_packed_glove(K):
            # as in the JAX package: "on" rejects the width, "auto" would
            # take the in-jit engine
            if self.packed == "on":
                raise ValueError(
                    "packed='on' requires num_components <= 124 (the "
                    "augmented payload K+2 plus two decoration lanes must "
                    "lane-pack)")
            raise NotImplementedError(
                f"num_components > 124 needs the in-jit engine, which "
                f"{_LATER}")

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
        central = coo.row.astype(np.int32)[order]
        context = coo.col.astype(np.int32)[order]
        counts = coo.data.astype(np.float64)[order]

        N = len(central)
        B = min(self.batch_size, max(N, 1))
        if self.engine == "xla":
            B = -(-B // 1024) * 1024
        S = max(1, -(-N // B))
        pad = S * B - N
        if pad:
            central = np.concatenate([central, np.full(pad, PAD_CENTRAL)])
            context = np.concatenate([context, np.zeros(pad, np.int32)])
            counts = np.concatenate([counts, np.ones(pad)])
        if self.engine == "pallas":
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
        self._fit_packed_glove(c2, x2, n2, W_central, central_bias,
                               W_context, context_bias, N, num_epochs,
                               verbose, V1, V2, t0)

    def _fit_packed_glove(self, c2, x2, n2, W_central, central_bias,
                          W_context, context_bias, N, num_epochs, verbose,
                          V1, V2, t0):
        """Packed fused engine (`ops/glove_epoch.py`): every stream is
        static per fit, so the prep runs once and each epoch replays it."""
        dev = self.device
        K = self.num_components
        Kp = K + 2
        wrows_w, wrows_h = 256, 256
        rw = pk.packed_rows(V1, Kp, multiple=wrows_w)
        rh = pk.logical_rows(V2, multiple=wrows_h)
        self.packed_engine_ = True
        m2, f2, l2, winw, sx, rowsx, winx = prep_glove_static(
            c2, x2, n2, V1, K, rw, rh, wrows_w, wrows_h, self.x_max,
            self.alpha)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Zc_np, Zx_np = augment_tables(W_central, central_bias, W_context,
                                      context_bias)
        Zc = put(pk.pack_array(Zc_np.astype(np.float32), Kp,
                               multiple=wrows_w))
        Zx = put(pk.pack_logical(Zx_np.astype(np.float32), Kp,
                                 multiple=wrows_h))
        opt = PackedAdaGrad(self.learning_rate)
        oc, ox = opt.init(Zc), opt.init(Zx)
        dev_streams = [put(a) for a in (c2, x2, m2, f2, l2, sx, rowsx, winx,
                                        winw)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prep_s_ = time.perf_counter() - t0
        self.epoch_times_ = []
        loss = None
        for it in range(num_epochs):
            t1 = time.perf_counter()
            loss = packed_glove_epoch(
                Zc, Zx, oc, ox, *dev_streams, N, lr=self.learning_rate, K=K,
                rw=rw, rh=rh, wrows_w=wrows_w, wrows_h=wrows_h)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(time.perf_counter() - t1)
            if verbose:
                print(f"ITER={it + 1:{len(str(num_epochs))}}, "
                      f"LOSS: {float(loss):.4f}", flush=True)

        self.last_loss = float(loss) if loss is not None else None
        Zc_log = pk.unpack_array(Zc.cpu().numpy(), V1, Kp)
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
            return torch.from_numpy(np.ascontiguousarray(
                a.astype(dtype).reshape(S, 1, chunk))).to(dev)

        Zc_np, Zx_np = augment_tables(W_central, central_bias, W_context,
                                      context_bias)
        Zc = pe.pack_table(Zc_np, "adagrad", dev)
        Zx = pe.pack_table(Zx_np, "adagrad", dev)
        # a masked sample reads row 0 and writes nothing
        streams = [put(np.where(keep, central, 0), np.int32),
                   put(context, np.int32), put(f, np.float32),
                   put(logcnt, np.float32), put(keep, np.int32)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prep_s_ = time.perf_counter() - t0
        self.epoch_times_ = []
        loss = None
        for it in range(num_epochs):
            t1 = time.perf_counter()
            loss = pe.glove_pallas_epoch(Zc, Zx, *streams,
                                         lr=self.learning_rate, k_dim=K,
                                         group=group)[2]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_times_.append(time.perf_counter() - t1)
            if verbose:
                print(f"ITER={it + 1:{len(str(num_epochs))}}, "
                      f"LOSS: {float(loss):.4f}", flush=True)

        self.packed_engine_ = False
        self.last_loss = float(loss) if loss is not None else None
        Zc_log = Zc[:V1, :K + 2].cpu().numpy()
        Zx_log = Zx[:V2, :K + 2].cpu().numpy()
        self._set_outputs(Zc_log, Zx_log, K)

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
