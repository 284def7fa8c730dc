"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device: requires CUDA, prints ``nvidia-smi`` name and power limit, and
   that float32 products run without TF32;
2. build: compiles the CUDA kernels from ``cymf_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   with timings.  The BPR kernels at the BPR main-path shapes (ML-20M:
   138,493 users x 26,744 items, 20,000,263 interactions, d=20, batch
   131,072; first step of the port's own prep), the sample kernel also at
   d=64; the v5 sample kernel (#4) and the v6 block step (#5) on step 0 of
   the ml-1m stream (6040 x 3706, 725,248 interactions, d=20, batch
   131,072) at ``wrows`` 256 and 512, which the data gate sends to v5 and
   v6; the v7 range step (#6) and the v8 pool step (#7, P = 1024) on the
   ML-20M step and on its last step (the padding tail), their ``Aw`` and
   ``Apool`` lane group by lane group, each timed by call and in a loop
   of 20; both windowed accumulations at the
   JAX default ``wrows``
   512 on that step's H side.  The batched Cholesky on the first diagonal
   block (C=2048, B=64) of the first standard-form user chunk of the WMF
   d=256 fit, and at C=1, C=262 and B=128, each timed by call and in a
   loop beside its plain version.  The GloVe/RelMF sample kernel
   and both of the step's windowed accumulations (W side, H side) on step
   0 of the device-prep RelMF epoch at ML-20M (d=20, batch 131,072, the
   port's own draws and hash-set labels) and on step 0 of the GloVe fit on
   the ``glove_packed`` bench stream (50,000 words, ~3M triples, d=50).
   The count-lane form of both accumulations (#2w/#3w, the wide engine)
   on step 0 of the ML-20M d=256 fit (batch 131,072, ``wrows`` 512) and
   of a K = 300 fit (width 384): payload within 1e-5 of its max, the
   count lane and the unused lanes exact.  Every single-stream call
   (#2, #2w; also the v8 item-side call on bpr-pool's first step, checked
   after that phase) prints its grid (CTAs, samples a CTA) and the
   stream's runs, and is timed beside the library calls that compute its
   function, each both ways: the median of 20 single calls between CUDA
   events, and the mean of 20 back-to-back calls (the host queues ahead,
   so the wrapper's host work hides as in a training step).  Every dual
   call (#3 at ``wrows`` 256 and 512, #3w at widths 256 and 384) prints
   its grid (each stream's parts) and must give the same bits on two
   calls; it is timed by call, in a loop and by device time a call, by
   CUDA kernel (``torch.profiler``), beside its bound;
   probes: P1 (``phase_v4r``) and P2 (``copy_phase``) at their scripts'
   shapes (B = 131,072, K = 20) beside #1; P3 (``gather_rows``) at R =
   27,136 and 131,072, width 128, random and sorted ids, and at the wide
   step's gathers (W (138,752 x 256) by its sorted users, H (27,136 x
   256) by its items), each beside ``index_select``;
4. relmf-ml20m: 1,000 steps of the device-prep RelMF epoch at ML-20M
   shapes (a depth cut of the 28,259-step epoch); ms a step, cells/s,
   peak device memory against its reckoned bound;
5. quickstart: BPR on a small synthetic dataset with validation and
   early stopping must beat an untrained model's test DCG@5 by 0.1,
   through pipeline v5, each of its kernels once a step;
6. full width: 3 epochs of BPR at ML-20M shapes through the public
   ``fit``; the sparse streams must keep pipeline v4, every BPR kernel
   run once per step;
7. the other BPR pipelines, each at full width (d=20) through its main
   path: bpr-ml1m, 3 epochs of ``fit`` on the ml-1m data (v5: #4 and both
   accumulations once a step, #1 never); bpr-v6, 3 sgd epochs of
   ``packed_bpr_epoch(kernel_v=6)`` on the ml-1m streams at ``wrows`` 512
   against ``kernel_v=4`` on the same streams; bpr-v7, 1 epoch of ``fit``
   at ML-20M under ``CYMF_TPU_PACKED_KERNEL=7`` (#6 and the H-side
   accumulation once a step, #1 and #2 never); bpr-pool, 2 epochs of
   ``BPR(neg_pool=1024).fit`` at ML-20M (#7 and the i-side accumulation
   once a step); pool-quickstart, ``neg_pool=128`` on the quickstart data
   must beat an untrained model by 0.1; bpr-wide, 2 epochs of
   ``BPR(num_components=256).fit`` at ML-20M (the wide engine: each
   count-lane accumulation once a step, no other kernel; peak device
   memory under its reckoned bound); wide-quickstart, ``BPR(128)`` on
   the quickstart data must beat an untrained model by 0.1;
8. ALS quickstart: WMF d=128 must beat an untrained model's test DCG@5 by
   0.1 through the Cholesky kernel; WMF and ExpoMF d=128 must match the
   same fits with the plain diagonal factor (``CYMF_TPU_ALS_CHOL=blocked``);
9. WMF full width: 2 epochs of WMF d=256 at ML-20M shapes through the
   public ``fit``; the Cholesky kernel must run K/64 = 4 times per
   standard-form chunk;
10. relmf-quickstart: RelMF d=20 with device prep on the quickstart data
    must beat an untrained model's test DCG@5 by 0.1;
11. relmf-full: 3 device-prep epochs of RelMF d=20 at ml-1m shapes (6040
    x 3706 cells an epoch, 171 steps) through the public ``fit``; the
    sample kernel must run once a step and the accumulation twice;
12. glove-full: 3 epochs of GloVe d=50 on the ``glove_packed`` stream
    through the public ``fit``; the same launch counts, and the
    constant-one columns must stay exactly one;
13. kernels, the sequential engine (``engine="pallas"``): each of its
    three kernels against its plain version on the first 2 chunks (8,192
    samples) of its first launch in a full-width fit: BPR and RelMF d=20
    at ml-100k shapes (943 x 1682; BPR on 55,296 distinct interactions)
    under sgd, adagrad and adam, GloVe d=50 on the JAX bench's small
    stream (5,000 words, 200,000 draws), each at group 1 and 8; then
    each timed at the whole launch that phase 15 counts (BPR's 10-epoch
    launch, and its epoch launch too; RelMF's and GloVe's epochs), which
    must give the same bits on two calls, with the placement of its
    tables that the kernels' plan chose (``cymf_seq_epoch_plan``: the
    block's shared memory or device memory); then the same checks on
    catalogs whose tables fit the block's shared memory, where the plan
    keeps them (BPR and RelMF on the quickstart data, 600 x 300, as
    ``pallas-quickstart`` runs BPR; GloVe on 256 words), each whole
    launch also timed with its tables forced into device memory, which
    must give the same bits;
14. pallas-quickstart: ``BPR(engine="pallas")`` on the quickstart data
    must beat an untrained model's test DCG@5 by 0.1;
15. pallas-full: the sequential engine through the public ``fit`` at
    those shapes: BPR 10 epochs without a validator must launch its
    kernel exactly once, BPR and RelMF 3 epochs with a validator and
    GloVe 3 epochs once an epoch; GloVe's constant-one columns must stay
    exactly one; BPR's epochs/s, on the device alone (``bench.py``'s
    measure) and over the fit's wall time, are printed beside
    ``bench.py``'s CPU reference (98.46 epochs/s on 8 threads).

Then it prints the kernels' JSON line (all seventeen), with each kernel's
launches on its main path (a probe's: those of the probes phase), the
accumulations' loop times (``loop_ms``, and ``library_loop_ms`` for the
single stream's library calls), the dual's device time (``device_ms``),
its bound (the larger of bytes over 3.35 TB/s and float32 operations over
67 TFLOP/s, counted on this run's inputs) and the time of the library call
that computes the same function: ``index_add_`` for ``sorted_accum``,
``index_add_`` and ``bincount`` for ``sorted_accum_wide``,
``index_select`` for ``gather_rows``, and for ``chol_inv_batched`` the two
calls of its plain version, ``cholesky_ex`` and ``solve_triangular``
(``library_call`` says so; no single PyTorch call computes both factors,
nor any other kernel's function); the fused kernels #4-#7, the
Cholesky and the GloVe/RelMF sample kernel also carry ``loop_ms`` (the
sample kernel its ``device_ms`` too, from ``torch.profiler``); the
sequential kernels' ``ms`` and ``bound_ms`` are those of the main-path
launch, beside ``slice_ms`` and ``plain_ms`` on 8,192 samples
(``plain_samples``), ``samples``, ``placement``, BPR's ``epoch_ms``,
and under ``small_catalog`` the same check and whole-launch time at the
block's shared memory with ``placement_0_ms`` beside it; and, last, the
device JSON line.
``--profile`` adds a ``torch.profiler`` split of one WMF d=256 epoch,
written to ``chiprun_out/wmf_profile.txt``, and of 50 device-prep RelMF
steps at ML-20M shapes with the card's idle share, written to
``chiprun_out/relmf_profile.txt``.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

U, I, NNZ = 138493, 26744, 20_000_263
BATCH, WROWS = 131072, 256
EPOCHS = 3
ALS_K, ALS_EPOCHS = 256, 2
BPR_KERNELS = {
    "bpr_sample_phase": ("cymf_tpu_torch/csrc/bpr_sample.cu",
                         "cymf_tpu/ops/fused_sample.py:317"),
    "sorted_accum": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                     "cymf_tpu/ops/sorted_accum.py:417"),
    "sorted_accum_dual": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                          "cymf_tpu/ops/sorted_accum.py:345"),
}
FUSED_SRC = "cymf_tpu_torch/csrc/bpr_fused.cu"
# the v5-v8 pipelines' kernels (#4-#7)
FUSED_KERNELS = {
    "bpr_sample_phase_v5": (FUSED_SRC, "cymf_tpu/ops/fused_sample.py:285"),
    "bpr_block_step_v6": (FUSED_SRC, "cymf_tpu/ops/fused_step.py:748"),
    "bpr_range_step_v7": (FUSED_SRC, "cymf_tpu/ops/fused_step.py:431"),
    "bpr_pool_step_v8": (FUSED_SRC, "cymf_tpu/ops/fused_step.py:679"),
}
SEQ_SRC = "cymf_tpu_torch/csrc/seq_epoch.cu"
PALLAS_KERNELS = {
    "bpr_pallas_epoch": (SEQ_SRC, "cymf_tpu/ops/pallas_engine.py:212"),
    "relmf_pallas_epoch": (SEQ_SRC, "cymf_tpu/ops/pallas_engine.py:333"),
    "glove_pallas_epoch": (SEQ_SRC, "cymf_tpu/ops/pallas_engine.py:435"),
}
# the wide BPR engine's count-lane form of #2/#3
WIDE_KERNELS = {
    "sorted_accum_wide": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                          "cymf_tpu/ops/sorted_accum.py:417"),
    "sorted_accum_dual_wide": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                               "cymf_tpu/ops/sorted_accum.py:345"),
}
PROBE_SRC = "cymf_tpu_torch/csrc/probes.cu"
# the probes P1-P3 of the JAX package's scripts/
PROBE_KERNELS = {
    "phase_v4r": (PROBE_SRC, "scripts/r5_kernel_variant.py:96"),
    "copy_phase": (PROBE_SRC, "scripts/r5_probes.py:77"),
    "gather_rows": (PROBE_SRC, "scripts/roofline_gather.py:74"),
}
KERNELS = {**BPR_KERNELS, **FUSED_KERNELS,
           "chol_inv_batched": ("cymf_tpu_torch/csrc/chol_inv.cu",
                                "cymf_tpu/ops/chol_kernel.py:109"),
           "glove_sample_phase": ("cymf_tpu_torch/csrc/glove_sample.cu",
                                  "cymf_tpu/ops/glove_epoch.py:161"),
           **PALLAS_KERNELS, **WIDE_KERNELS, **PROBE_KERNELS}
ALS_TOL = dict(rtol=2e-3, atol=2e-4)
RELMF_K, RELMF_EPOCHS, ML20M_STEPS = 20, 3, 1000
GLOVE_K, GLOVE_V, GLOVE_NNZ, GLOVE_EPOCHS = 50, 50_000, 3_000_000, 3
# the sequential engine: the JAX bpr_pallas bench's ml-100k shapes, and
# its small GloVe stream (5,000 words, 200,000 draws)
ML100K_U, ML100K_I, ML100K_N, PALLAS_K = 943, 1682, 55_296, 20
GLOVE_SMALL_V, GLOVE_SMALL_NNZ, SEQ_CHUNKS, PALLAS_EPOCHS = 5000, 200_000, 2, 3
# a GloVe catalog whose tables (d=50 under AdaGrad, 416 B a row) fit the
# sequential kernel's block beside its ring, as the quickstart's BPR does
GLOVE_TINY_V, GLOVE_TINY_NNZ = 256, 20_000
# bench.py's bpr_pallas mode divides by the Cython reference's epochs/s
# on 8 CPU threads at these shapes
BENCH_SEQ_CPU_EPOCHS_S = 98.46
# the BPR pipelines' other data: the JAX relmf bench's ml-1m shapes
# (6040 x 3706, density 0.04: 725,248 train interactions, 6 steps), the
# pool size of the JAX bpr_pool bench mode, and the v6 comparison's sgd
# step
ML1M_U, ML1M_I, POOL_P, V6_LR = 6040, 3706, 1024, 0.05
# the wide engine (K >= 128): BASELINE config 5's BPR at d=256 on ML-20M,
# 512-row windows on both sides as BPR._fit_wide sets them
WIDE_K, WIDE_WROWS, WIDE_EPOCHS = 256, 512, 2
# the H100 SXM's published peaks: HBM3 bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back calls between two
    CUDA events, after a warm-up: the host queues ahead of the card, so a
    wrapper's host work (checks, allocation, the launch) hides behind the
    kernels as it does in a training step, where :func:`time_ms`'s events
    around one call include it."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_split(fn, reps: int = 20) -> dict:
    """Device time of ``fn()`` a call by CUDA kernel (memsets included),
    ``{name: ms}``, from ``torch.profiler`` over ``reps`` back-to-back
    calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            split[ev.key[:60]] = t / 1e3 / reps
    return split


def bound(nbytes: float, ops: float) -> dict:
    """``bound_ms``, the least time the card could take for the work: the
    larger of ``nbytes`` (each input read once, each output written once)
    over the memory rate and ``ops`` over the float32 rate; and which of
    the two it is (``bound_by``)."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_S
    by_ops = 1e3 * ops / PEAK_F32_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def close(got, want, rtol, atol, what):
    """Max abs and rel error; raises unless |got-want| <= atol + rtol|want|
    everywhere and both are finite."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    bad = err > atol + rtol * want.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements off "
                             f"(max abs {max_abs:.3e}, rel {max_rel:.3e})")
    return max_abs, max_rel


def bench_matrix():
    from scipy import sparse

    from cymf_tpu_torch.dataset import bench_interactions
    users, items = bench_interactions(U, I, NNZ, seed=0)
    X = sparse.csr_matrix((np.ones(NNZ), (users, items)), shape=(U, I))
    X.sum_duplicates()
    X.data[:] = 1.0
    return X


def first_step(X, K: int, dev, step: int = 0):
    """Inputs of the three kernels at step ``step`` (0 by default; -1 is
    the last step, with the padding tail) of the port's prep over X."""
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.fused_sample import decorate
    from cymf_tpu_torch.ops.packed_epoch import prep_epoch, prep_static

    u2, i2 = sorted_batches(*shuffled_interactions(X), BATCH)
    one = slice(step, step + 1 or None)
    u2, i2 = u2[one], i2[one]
    rw = pk.packed_rows(U, K, multiple=WROWS)
    rh = pk.logical_rows(I, multiple=WROWS)
    winw, _, si, rowsi, wini, *_ = prep_static(u2, i2, K, rw, rh, WROWS,
                                               WROWS)
    coo = X.tocoo()
    pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
    j2, mask, sj, rowsj, winj = prep_epoch(
        np.random.default_rng((1234, 0)), u2, i2, pos_keys, U, I, K, rh,
        WROWS)
    rng = np.random.default_rng(0)
    Wp = pk.pack_array(rng.uniform(-0.1, 0.1, (U, K)) / K, K, WROWS)
    Hp = pk.pack_logical(rng.uniform(-0.1, 0.1, (I, K)) / K, K, WROWS)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
         dict(Wp=Wp, Hp=Hp, u=u2[0], i=i2[0], j=j2[0], mask=mask[0],
              si=si[0], rowsi=rowsi[0], wini=wini[0], sj=sj[0],
              rowsj=rowsj[0], winj=winj[0], winw=winw[0]).items()}
    s = pk.num_slots(K)
    t["phys"] = t["u"] // s
    t["Du"] = decorate(t["Wp"].index_select(0, t["phys"].clamp(max=rw - 1)),
                       t["u"] % s, t["mask"].float(), K)
    t["Di"] = t["Hp"].index_select(0, t["i"])
    t["Dj"] = t["Hp"].index_select(0, t["j"])
    t["u2"], t["i2"], t["pos_keys"] = u2, i2, pos_keys
    return t, rw, rh


def check_kernels(X, dev):
    """Phase 3: every kernel against its plain version on the card."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import packed as pk

    results = {}
    for K in (20, 64):
        t, rw, rh = first_step(X, K, dev)
        args = (t["Du"], t["Di"], t["Dj"])
        SW, Q, loss = fs.bpr_sample_phase(*args, K=K, wd=0.01)
        SWp, Qp, lossp = fs.bpr_sample_phase_plain(*args, K=K, wd=0.01)
        torch.cuda.synchronize()
        e_sw = close(SW, SWp, 1e-5, 1e-6, f"SW K={K}")
        e_q = close(Q, Qp, 1e-5, 1e-6, f"Q K={K}")
        e_l = close(loss, lossp, 1e-5, 0.0, f"loss K={K}")
        msg = (f"bpr_sample_phase K={K}: SW max abs {e_sw[0]:.3e} rel "
               f"{e_sw[1]:.3e}; Q max abs {e_q[0]:.3e} rel {e_q[1]:.3e}; "
               f"loss {float(loss):.6f} vs {float(lossp):.6f} "
               f"(rel {e_l[1]:.3e})")
        if K == 20:
            ms = time_ms(lambda: fs.bpr_sample_phase(*args, K=K, wd=0.01))
            pms = time_ms(lambda: fs.bpr_sample_phase_plain(*args, K=K,
                                                            wd=0.01))
            # three (B, 128) rows read, SW and Q written; per row the slot
            # extraction and placement (2 x 128 x slots) and ~20
            # elementwise operations a lane
            B = args[0].shape[0]
            results["bpr_sample_phase"] = dict(
                max_abs_err=max(e_sw[0], e_q[0]), ms=ms, plain_ms=pms,
                **bound(5 * B * 128 * 4,
                        B * 128 * (2 * pk.num_slots(K) + 20)),
                library_ms=None)
            msg += f"; {ms:.4f} ms vs plain {pms:.4f} ms"
        phase("kernels", msg)
        if K != 20:
            continue

        w_args = (t["phys"], SW, t["winw"][0], t["winw"][1])
        results["sorted_accum"] = check_sorted_accum(
            w_args, dict(r_pad=rw, wrows=WROWS),
            f"ML-20M d={K} step 0, W side, wrows {WROWS}")
        h_args = (t["rowsi"], Q.index_select(0, t["si"]), t["wini"][0],
                  t["wini"][1], t["rowsj"], Q.index_select(0, t["sj"]),
                  t["winj"][0], t["winj"][1])
        results["sorted_accum_dual"] = check_dual(
            h_args, dict(r_pad=rh, neg_lanes=K, wrows=WROWS),
            f"ML-20M d={K} step 0, H side, wrows {WROWS}")
    return results


class forced_kernel:
    """``CYMF_TPU_PACKED_KERNEL`` set to ``value`` inside the block (the
    JAX package's switch, which the port honours), restored after."""

    def __init__(self, value: str):
        self.value = value

    def __enter__(self):
        self.saved = os.environ.get("CYMF_TPU_PACKED_KERNEL")
        os.environ["CYMF_TPU_PACKED_KERNEL"] = self.value

    def __exit__(self, *exc):
        os.environ.pop("CYMF_TPU_PACKED_KERNEL")
        if self.saved is not None:
            os.environ["CYMF_TPU_PACKED_KERNEL"] = self.saved


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ml1m_matrix():
    """The JAX relmf bench's ml-1m-shaped data (6040 x 3706, density 0.04,
    seed 0): its train split."""
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    return SyntheticImplicitDataset(num_user=ML1M_U, num_item=ML1M_I, rank=8,
                                    density=0.04, seed=0).train


def ml1m_streams(X1, K: int, wrows: int):
    """``BPR.fit``'s sorted batches of X1 (shuffled under
    ``np.random.seed(0)``) and their ``prep_static`` at ``wrows``."""
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.packed_epoch import prep_static

    np.random.seed(0)
    u2, i2 = sorted_batches(*shuffled_interactions(X1), BATCH)
    rw = pk.packed_rows(ML1M_U, K, multiple=wrows)
    rh = pk.logical_rows(ML1M_I, multiple=wrows)
    return u2, i2, rw, rh, prep_static(u2, i2, K, rw, rh, wrows, wrows)


def aw_lanes(K: int) -> list:
    """Lane groups of a fused step's ``Aw`` for :func:`check_fused`, each
    ``(name, lanes, rtol, rel)``: |kernel - plain| <= rel max|plain over
    the group| + rtol |plain|.  The payload [0, cb) within 1e-5 of its own
    max: a slot-placement or lane-rotation fault of the fused W path shows
    only there, and the loss lane's sums (~190 at ML-20M) would hide it
    under a limit taken over all lanes.  The count channel [cb, cb + s) and
    the unused lanes exact: sums of 0/1 masks and of zeros.  The loss lane
    127 within 1e-5 relative (sums in another order)."""
    from cymf_tpu_torch.ops import packed as pk
    s, cb = pk.num_slots(K), pk.count_base(K)
    return [("payload", slice(0, cb), 0.0, 1e-5),
            ("counts", slice(cb, cb + s), 0.0, 0.0),
            ("unused", slice(cb + s, 127), 0.0, 0.0),
            ("loss", slice(127, 128), 1e-5, 0.0)]


def apool_lanes(K: int) -> list:
    """Lane groups of v8's ``Apool``, as :func:`aw_lanes`: the payload [0,
    K) within 1e-5 of its own max (float atomics, order changing from run
    to run), the count lane K and the rest exact."""
    return [("payload", slice(0, K), 0.0, 1e-5),
            ("counts", slice(K, K + 1), 0.0, 0.0),
            ("unused", slice(K + 1, 128), 0.0, 0.0)]


def check_fused(name, fn, plain, args, kw, outs, limits, nbytes_in, ops):
    """Phase 3 for one of #4-#7: kernel against plain on ``args``; each
    output checked as ``limits`` says (``("rows", rtol, atol)``, or
    ``("lanes", groups)`` group by group as :func:`aw_lanes` gives
    them)."""
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    errs, parts = [], []
    for g, w, what, lim in zip(got, want, outs, limits):
        if lim[0] == "rows":
            e = close(g, w, lim[1], lim[2], f"{name} {what}")
            parts.append(f"{what} max abs {e[0]:.3e} rel {e[1]:.3e}")
            errs.append(e[0] if w.dim() else 0.0)
            continue
        for group, lanes, rtol, rel in lim[1]:
            wg = w[:, lanes]
            if not wg.numel():
                continue
            atol = rel * float(wg.abs().max())
            e = close(g[:, lanes], wg, rtol, atol, f"{name} {what} {group}")
            limit = (f"{rel:g} max|{group}| = {atol:.3e}" if rel else
                     f"rtol {rtol:g}" if rtol else "exact")
            parts.append(f"{what} {group} max abs {e[0]:.3e} rel "
                         f"{e[1]:.3e} (limit {limit})")
            errs.append(e[0])
    ms = time_ms(lambda: fn(*args, **kw))
    lms = loop_ms(lambda: fn(*args, **kw))
    pms = time_ms(lambda: plain(*args, **kw))
    out_bytes = sum(nbytes(g) for g in got)
    b = bound(nbytes_in + out_bytes, ops)
    phase("kernels", f"{name}: {'; '.join(parts)}; {ms:.4f} ms a call, "
          f"{lms:.4f} in a loop (bound {b['bound_ms']:.4f}) vs plain "
          f"{pms:.4f} ms")
    return dict(max_abs_err=max(errs), ms=ms, loop_ms=lms, plain_ms=pms, **b,
                library_ms=None)


def pool_step_args(t, K: int, rw: int, rh: int, dev) -> tuple:
    """The v8 pool step's (#7) arguments on the step of
    :func:`first_step` (``t``): P = 1024 pool rows and the slots drawn as
    ``BPR(neg_pool=1024)`` draws them, the step's window ranges."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.packed_epoch import (prep_pool_epoch,
                                                 prep_static_pool)
    winp, *_ = prep_static_pool(t["u2"], t["i2"], K, rw, rh, WROWS, WROWS)
    r2 = np.random.default_rng((1234, 1 << 20)).integers(
        0, POOL_P, t["u2"].shape, dtype=np.int32)
    pool2, rjs, maskp, _ = prep_pool_epoch(
        np.random.default_rng((1234, 0)), t["u2"], t["pos_keys"], U, I,
        POOL_P, r2=r2)
    pool, rj, mp = (torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
                    for a in (pool2, rjs, maskp))
    s = pk.num_slots(K)
    Dup = fs.decorate(t["Wp"].index_select(0, t["phys"].clamp(max=rw - 1)),
                      t["u"] % s, mp.float(), K)
    stp, ctp = (torch.from_numpy(a).to(dev) for a in winp[0])
    return (t["phys"], rj, Dup, t["Di"], t["Hp"].index_select(0, pool),
            stp, ctp)


def check_fused_kernels(X, dev):
    """Phase 3 for #4-#7 on step 0 of their main paths: v5 and v6 on the
    ml-1m stream at d=20 (``wrows_w`` 256 gives v5, 512 gives v6), v7 and
    v8 (P = 1024) on the ML-20M stream of :func:`first_step`; and the
    windowed accumulations at the JAX default ``wrows = 512`` on that
    step's H side; v7 and v8 also on the ML-20M stream's last step, whose
    padding tail every CTA shares.  Limits: SW and Q rtol 1e-5, atol 1e-6,
    the loss relative 1e-5, Aw and Apool by lane group (:func:`aw_lanes`,
    :func:`apool_lanes`), the accumulations 1e-5 max|plain|."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import fused_step as fst
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops import sorted_accum as sa
    from cymf_tpu_torch.ops.packed_epoch import prep_epoch, prep_static
    K, s = 20, pk.num_slots(20)
    rows_lim = ("rows", 1e-5, 1e-6)
    results = {}
    X1 = ml1m_matrix()
    coo = X1.tocoo()
    keys1 = np.sort(coo.row.astype(np.int64) * ML1M_I + coo.col)
    rng = np.random.default_rng(0)
    W1 = rng.uniform(-0.1, 0.1, (ML1M_U, K)) / K
    H1 = rng.uniform(-0.1, 0.1, (ML1M_I, K)) / K
    for name, wrows, want_v in (("bpr_sample_phase_v5", 256, 5),
                                ("bpr_block_step_v6", 512, 6)):
        u2, i2, rw, rh, prep = ml1m_streams(X1, K, wrows)
        winw, wstart, si, rowsi, wini, cs, cn, v = prep
        if v != want_v:
            raise AssertionError(f"the ml-1m stream at wrows {wrows} takes "
                                 f"v{v}, expected v{want_v}")
        j2, mask, *_ = prep_epoch(np.random.default_rng((1234, 0)), u2[:1],
                                  i2[:1], keys1, ML1M_U, ML1M_I, K, rh,
                                  wrows)
        Wp, Hp, u, i, j, mf, ws = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                pk.pack_array(W1, K, wrows), pk.pack_logical(H1, K, wrows),
                u2[0], i2[0], j2[0], mask[0], wstart[0]))
        phys = u // s
        Di = Hp.index_select(0, i)
        Dj = fs.decorate(Hp.index_select(0, j), u % s, mf.float(), K)
        B = Di.shape[0]
        # per sample the slot extraction and placement (2 x 128 x slots)
        # and ~20 elementwise operations a lane; v6 adds the row sums
        ops = B * 128 * (2 * s + 20)
        if v == 5:
            args = (Wp, ws, phys, Di, Dj)
            results[name] = check_fused(
                name + f" (ml-1m step 0, B={B})", fs.bpr_sample_phase_v5,
                fs.bpr_sample_phase_v5_plain, args, dict(K=K, wd=0.01),
                ("SW", "Q", "loss"), (rows_lim, rows_lim, ("rows", 1e-5, 0)),
                nbytes(*args), ops)
        else:
            cs_d, cn_d = (torch.from_numpy(a[0]).to(dev) for a in (cs, cn))
            args = (Wp, phys, Di, Dj, ws, cs_d, cn_d)
            results[name] = check_fused(
                name + f" (ml-1m step 0, B={B}, wrows 512)",
                fst.bpr_block_step_v6, fst.bpr_block_step_v6_plain, args,
                dict(K=K, wd=0.01, rw=rw, wrows=wrows), ("Aw", "Q"),
                (("lanes", aw_lanes(K)), rows_lim), nbytes(*args),
                ops + B * 128)

    for step in (-1, 0):
        t, rw, rh = first_step(X, K, dev, step)
        B = t["Du"].shape[0]
        when = (f"ML-20M step 0, B={B}" if step == 0 else
                f"ML-20M last step, B={B}, "
                f"{int((t['phys'] >= rw).sum())} padding samples")
        with forced_kernel("7"):
            winw7, *_, v = prep_static(t["u2"], t["i2"], K, rw, rh, WROWS,
                                       WROWS)
        if v != 7:
            raise AssertionError(f"forcing v7 gave v{v}")
        st, ct = (torch.from_numpy(a).to(dev) for a in winw7[0])
        args = (t["phys"], t["Du"], t["Di"], t["Dj"], st, ct)
        results["bpr_range_step_v7"] = check_fused(
            f"bpr_range_step_v7 ({when})", fst.bpr_range_step_v7,
            fst.bpr_range_step_v7_plain, args,
            dict(K=K, wd=0.01, rw=rw, wrows=WROWS), ("Aw", "Q"),
            (("lanes", aw_lanes(K)), rows_lim), nbytes(*args),
            B * 128 * (2 * s + 21))

        args = pool_step_args(t, K, rw, rh, dev)
        results["bpr_pool_step_v8"] = check_fused(
            f"bpr_pool_step_v8 ({when}, P={POOL_P})",
            fst.bpr_pool_step_v8, fst.bpr_pool_step_v8_plain, args,
            dict(K=K, wd=0.01, rw=rw, wrows=WROWS), ("Aw", "Apool", "Q"),
            (("lanes", aw_lanes(K)), ("lanes", apool_lanes(K)), rows_lim),
            nbytes(*args), B * 128 * (2 * s + 22))
        del args

    # the windowed accumulations at wrows = 512 on the step's H side
    _, Q, _ = fs.bpr_sample_phase(t["Du"], t["Di"], t["Dj"], K=K, wd=0.01)
    rh5 = pk.logical_rows(I, multiple=512)
    sides = []
    for rows, perm in ((t["rowsi"], t["si"]), (t["rowsj"], t["sj"])):
        win = sa.window_ranges(rows.reshape(-1).cpu().numpy(), rh5, 512,
                               1024, align=128)
        sides += [rows, Q.index_select(0, perm)] + [
            torch.from_numpy(a).to(dev) for a in win]
    check_sorted_accum(tuple(sides[:4]), dict(r_pad=rh5, wrows=512),
                       "ML-20M step 0, i side, wrows 512")
    check_dual(tuple(sides), dict(r_pad=rh5, neg_lanes=K, wrows=512),
               "ML-20M d=20 step 0, H side, wrows 512")
    return results


def accum_bound(args, r_pad: int, out_lanes: int = 128) -> dict:
    """:func:`bound` of a windowed accumulation: its rows, gradients and
    windows read, the (r_pad, out_lanes) output written; an add per
    gradient element that lands in range."""
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + r_pad * out_lanes * 4)
    streams = [(args[0], args[1])] + ([(args[4], args[5])] if len(args) > 4
                                      else [])
    ops = sum(int((rows.reshape(-1)[:g.shape[0]] < r_pad).sum()) * g.shape[1]
              for rows, g in streams)
    return bound(nbytes, ops)


def wide_step0(X, dev, Ks=(WIDE_K, 300)):
    """Step 0 of the wide engine's ML-20M fit (batch 131,072, ``wrows``
    512, the port's prep as ``BPR._fit_wide`` runs it), for each K in
    ``Ks``: the sorted streams with dead samples at the sentinels, ``SW``
    and ``Q`` of :func:`wide_sample_phase` on random tables, and both
    accumulations' arguments, ``{K: (w_args, h_args, rw, rh)}``; also the
    step's user and item ids and the tables of the first K."""
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import wide_epoch as we
    from cymf_tpu_torch.ops.packed_epoch import prep_epoch

    np.random.seed(0)
    u2, i2 = sorted_batches(*shuffled_interactions(X), BATCH)
    u2, i2 = u2[:1], i2[:1]
    rw, rh = we.wide_rows(U, WIDE_WROWS), we.wide_rows(I, WIDE_WROWS)
    rowsu, winw, si, rowsi, wini = we.prep_static_wide(u2, i2, rw, rh,
                                                       WIDE_WROWS)
    coo = X.tocoo()
    pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
    j2, mask, sj, rowsj, winj = prep_epoch(
        np.random.default_rng((1234, 0)), u2, i2, pos_keys, U, I, Ks[0], rh,
        WIDE_WROWS)
    mi2, mj2 = we.wide_sorted_masks(mask, si, sj)
    t = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(dev) for k, v in
         dict(u=u2, i=i2, j=j2, mask=mask, rowsu=rowsu, winw=winw, si=si,
              rowsi=rowsi, wini=wini, sj=sj, rowsj=rowsj, winj=winj,
              mi=mi2, mj=mj2).items()}
    # dead and padding samples at the sentinels, as wide_bpr_epoch does
    rowsu_m = torch.where(t["mask"].reshape(t["rowsu"].shape) > 0,
                          t["rowsu"], rw)
    rowsi_m = torch.where(t["mi"] > 0, t["rowsi"], rh)
    rowsj_m = torch.where(t["mj"] > 0, t["rowsj"], rh)
    out = {}
    rng = np.random.default_rng(0)
    for K in Ks:
        W = torch.from_numpy(we.pack_wide(
            rng.uniform(-0.1, 0.1, (U, K)) / K, K, WIDE_WROWS)).to(dev)
        H = torch.from_numpy(we.pack_wide(
            rng.uniform(-0.1, 0.1, (I, K)) / K, K, WIDE_WROWS)).to(dev)
        SW, Q, _ = we.wide_sample_phase(W, H, t["u"], t["i"], t["j"],
                                        t["mask"].float(), rw=rw, wd=0.01)
        w_args = (rowsu_m, SW, t["winw"][0], t["winw"][1])
        h_args = (rowsi_m, Q.index_select(0, t["si"]), t["wini"][0],
                  t["wini"][1], rowsj_m, Q.index_select(0, t["sj"]),
                  t["winj"][0], t["winj"][1])
        out[K] = (w_args, h_args, rw, rh)
        if K == Ks[0]:
            out["ids"] = (t["u"], t["i"], W, H)
        del SW, Q
    return out


def check_wide_kernels(X, dev):
    """Phase 3 for #2/#3's count-lane form (``sorted_accum_wide``,
    ``sorted_accum_dual_wide``): both accumulations of step 0 of the
    ML-20M d=256 fit (width 256) and of a K = 300 fit (width 384, three
    granules a row), kernel against plain, the single stream by
    :func:`check_sorted_accum` (with the library calls that compute its
    function), the dual by :func:`check_dual`."""
    steps = wide_step0(X, dev)
    results = {}
    for K in (WIDE_K, 300):
        w_args, h_args, rw, rh = steps[K]
        width = w_args[1].shape[1]
        res = check_sorted_accum(
            w_args, dict(r_pad=rw, wrows=WIDE_WROWS, count_lanes=True),
            f"ML-20M d={K} step 0, W side, wrows {WIDE_WROWS}")
        if K == WIDE_K:
            results["sorted_accum_wide"] = res
        res = check_dual(
            h_args, dict(r_pad=rh, neg_lanes=width, wrows=WIDE_WROWS,
                         count_lanes=True),
            f"ML-20M d={K} step 0, H side, wrows {WIDE_WROWS}")
        if K == WIDE_K:
            results["sorted_accum_dual_wide"] = res
    return results, steps["ids"]


def probe_tiles(dev, K: int = 20):
    """The probe scripts' inputs (``scripts/r5_kernel_variant.py``'s main):
    a decorated packed W tile (``mask * onehot(slot)`` from lane ``cb``)
    and logical item tiles, zero on lanes >= K, B = 131,072."""
    from cymf_tpu_torch.ops import packed as pk
    rng = np.random.default_rng(0)
    s, cb = pk.num_slots(K), pk.count_base(K)
    Du = rng.normal(size=(BATCH, 128)).astype(np.float32)
    slot = rng.integers(0, s, BATCH)
    mf = (rng.random(BATCH) > 0.1).astype(np.float32)
    Du[:, cb:] = 0.0
    Du[np.arange(BATCH), cb + slot] = mf
    Di = rng.normal(size=(BATCH, 128)).astype(np.float32)
    Dj = rng.normal(size=(BATCH, 128)).astype(np.float32)
    Di[:, K:] = 0.0
    Dj[:, K:] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (Du, Di, Dj)]


def one_ulp(want):
    """One float32 ulp at each |want|."""
    a = want.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def probes(ids, dev):
    """The probes P1-P3 (``csrc/probes.cu``) at their scripts' shapes, each
    against its plain form and timed beside what it measures: P1
    (``phase_v4r``) and P2 (``copy_phase``) beside #1 on the same tiles
    (P1's SW and Q within an ulp of #1's kernel, its loss 1e-5 relative; P2
    exact); P3 (``gather_rows``) at R = 27,136 and 131,072, width 128, by
    random and sorted ids, and at the wide step's gathers, W (rw, 256) by
    the step's sorted user ids and H (rh, 256) by its item ids, exact and
    beside ``index_select``.  The launches counted are the checked calls'
    (the phase's own run), not the timing repetitions'.  Returns
    ``(results, launches)``."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops import probes as pr

    K, wd = 20, 0.01
    tiles = probe_tiles(dev, K)
    B = BATCH
    _kernels.reset_launches()
    SW, Q, loss = pr.phase_v4r(*tiles, K=K, wd=wd)
    cp = pr.copy_phase(*tiles)
    gathers = []
    rng = np.random.default_rng(1)
    for R in (27136, 131072):
        T = torch.from_numpy(rng.normal(size=(R, 128)).astype(
            np.float32)).to(dev)
        idx = rng.integers(0, R, B).astype(np.int32)
        for order, ix in (("random", idx), ("sorted", np.sort(idx))):
            ix = torch.from_numpy(ix).to(dev)
            gathers.append((f"R={R} w=128 {order} ids", T, ix,
                            pr.gather_rows(T, ix)))
    u, i, W, H = ids
    for what, T, ix in (("W (rw, 256) by the wide step's sorted user ids", W,
                         u),
                        ("H (rh, 256) by its item ids", H, i)):
        gathers.append((what, T, ix, pr.gather_rows(T, ix)))
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)

    # P1 against #1's kernel (an ulp) and #1's plain form (#1's limits)
    SW1, Q1, loss1 = fs.bpr_sample_phase(*tiles, K=K, wd=wd)
    SWp, Qp, lossp = pr.phase_v4r_plain(*tiles, K=K, wd=wd)
    torch.cuda.synchronize()
    for what, got, want in (("SW", SW, SW1), ("Q", Q, Q1)):
        ulps = int(((got - want).abs() > one_ulp(want)).sum())
        if ulps:
            raise AssertionError(f"phase_v4r {what}: {ulps} elements more "
                                 "than an ulp off #1's kernel")
    e_sw = close(SW, SWp, 1e-5, 1e-6, "phase_v4r SW")
    e_q = close(Q, Qp, 1e-5, 1e-6, "phase_v4r Q")
    e_l1 = close(loss, loss1, 1e-5, 0.0, "phase_v4r loss vs #1")
    close(loss, lossp, 1e-5, 0.0, "phase_v4r loss vs plain")
    ms1 = time_ms(lambda: fs.bpr_sample_phase(*tiles, K=K, wd=wd))
    ms = time_ms(lambda: pr.phase_v4r(*tiles, K=K, wd=wd))
    pms = time_ms(lambda: pr.phase_v4r_plain(*tiles, K=K, wd=wd))
    results = {"phase_v4r": dict(
        max_abs_err=max(e_sw[0], e_q[0]), ms=ms, plain_ms=pms,
        **bound(5 * B * 128 * 4, B * 128 * (2 * pk.num_slots(K) + 20)),
        library_ms=None)}
    phase("probes", f"P1 phase_v4r (B={B}, K={K}): SW, Q within an ulp of "
          f"#1's kernel; vs plain SW max abs {e_sw[0]:.3e}, Q {e_q[0]:.3e}; "
          f"loss {float(loss):.6f} vs #1 {float(loss1):.6f} (rel "
          f"{e_l1[1]:.3e}); {ms:.4f} ms vs #1 {ms1:.4f} ms, plain "
          f"{pms:.4f} ms, bound {results['phase_v4r']['bound_ms']:.4f} ms")

    errs = [close(g, w, 0.0, 0.0, f"copy_phase {n}")[0] for g, w, n in
            zip(cp, pr.copy_phase_plain(*tiles), ("SW", "Q", "loss"))]
    ms = time_ms(lambda: pr.copy_phase(*tiles))
    pms = time_ms(lambda: pr.copy_phase_plain(*tiles))
    results["copy_phase"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=pms,
        **bound(5 * B * 128 * 4 + 8 * 128 * 4, 2 * B * 128),
        library_ms=None)
    phase("probes", f"P2 copy_phase (B={B}): exact; {ms:.4f} ms vs #1 "
          f"{ms1:.4f} ms, plain {pms:.4f} ms, bound "
          f"{results['copy_phase']['bound_ms']:.4f} ms")

    for what, T, ix, got in gathers:
        close(got, pr.gather_rows_plain(T, ix), 0.0, 0.0,
              f"gather_rows {what}")
        ms = time_ms(lambda: pr.gather_rows(T, ix))
        pms = time_ms(lambda: pr.gather_rows_plain(T, ix))
        lms = time_ms(lambda: torch.index_select(T, 0, ix))
        n = ix.shape[0]
        b = bound(n * 4 + 2 * n * T.shape[1] * 4, 0)
        phase("probes", f"P3 gather_rows {what} (B={n}, table "
              f"{tuple(T.shape)}, rows in flight 8): exact; {ms:.4f} ms "
              f"({n / ms / 1e3:.1f}M rows/s) vs index_select {lms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms")
        if what.startswith("R=131072 w=128 random"):
            # the script's own pallas_gather shape is the JSON entry's, and
            # its sweep of rows in flight (the script's q)
            results["gather_rows"] = dict(max_abs_err=0.0, ms=ms,
                                          plain_ms=pms, **b, library_ms=lms)
            sweep = []
            for q in pr.ROWS_IN_FLIGHT:
                close(pr.gather_rows(T, ix, rows_in_flight=q),
                      pr.gather_rows_plain(T, ix), 0.0, 0.0,
                      f"gather_rows {what}, {q} rows in flight")
                qms = time_ms(lambda: pr.gather_rows(T, ix, rows_in_flight=q))
                sweep.append(f"{q}: {qms:.4f} ms")
            phase("probes", f"P3 gather_rows {what}, exact at every count "
                  f"of rows in flight a warp: {', '.join(sweep)}")
    return results, launches


def quickstart(dev, neg_pool: int = 0):
    """Phase 4: the README quickstart on the card, through pipeline v5 (a
    small dense catalog) or, with ``neg_pool``, v8; each of the pipeline's
    kernels must run once a step of every epoch the fit ran."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.ops import _kernels

    name = "pool-quickstart" if neg_pool else "quickstart"
    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                            device=dev)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    kw = dict(num_components=20, learning_rate=0.01, weight_decay=0.01,
              neg_pool=neg_pool, device=dev)
    m0 = ct.BPR(**kw)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.BPR(**kw)
    _kernels.reset_launches()
    m.fit(d.train, num_epochs=30, valid_evaluator=valid, early_stopping=True,
          verbose=False)
    launches = dict(_kernels.launches)
    res = test.evaluate(m.W, m.H)
    n = len(m.epoch_times_) * -(-m._samples_per_epoch // 1024)
    want_v, want = (8, {"bpr_pool_step_v8": n, "sorted_accum": n}) \
        if neg_pool else (5, {"bpr_sample_phase_v5": n, "sorted_accum": n,
                              "sorted_accum_dual": n})
    phase(name, f"test {res}; untrained DCG@5 {base:.4f}; best valid "
          f"DCG@5 {m.valid_dcg:.4f}; last loss {m.last_loss:.4f}; pipeline "
          f"v{m.packed_kernel_}; {len(m.epoch_times_)} epochs; launches "
          f"{launches}")
    if m.packed_kernel_ != want_v or launches != want:
        raise AssertionError(f"{name}: pipeline v{m.packed_kernel_}, "
                             f"launches {launches}, expected v{want_v}, "
                             f"{want}")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError(f"the {name} did not learn")


class _DeviceProbe:
    """A stand-in validation evaluator that checks, once per epoch, that
    the live tables are on the card (it scores nothing)."""

    def __init__(self, model):
        self.model = model
        self.calls = 0

    def evaluate(self, W, H):
        if self.model._state["W"].device.type != "cuda":
            raise AssertionError("W left the card during the fit")
        self.calls += 1
        return {"DCG@5": 0.0}


def full_width(X, dev):
    """Phase 6: 3 epochs of the public fit at ML-20M shapes, pipeline v4
    (the sparse streams fail the v5/v6 span gate)."""
    return bpr_fit(X, dev, EPOCHS, "full", 4, dict.fromkeys(BPR_KERNELS, 1))


def bpr_fit(X, dev, epochs: int, what: str, want_v, want: dict,
            K: int = 20, reckon=None, **kw):
    """A full-width BPR fit (d=K, 20 by default; Adam lr 0.001, wd 0.01,
    batch 131,072) through the public ``fit``; its pipeline and launches
    must be ``want_v`` and ``want`` (launches per step, times the steps
    run); ``want_v`` None is the wide engine (K >= 128), which has no
    pipeline number.  With ``reckon`` (bytes), peak device memory must stay
    under it."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    m = ct.BPR(num_components=K, learning_rate=0.001, optimizer="adam",
               weight_decay=0.01, batch_size=BATCH, device=dev, **kw)
    probe = _DeviceProbe(m)
    N = X.count_nonzero()
    S = -(-N // BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m.fit(X, num_epochs=epochs, valid_evaluator=probe, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    for e, st in enumerate(m.epoch_times_):
        phase(what, f"epoch {e}: host prep {st['prep_s']:.3f} s, device "
              f"{st['device_s']:.3f} s, {N / st['device_s']:.4e} int/s "
              f"device, {N / (st['prep_s'] + st['device_s']):.4e} int/s "
              "prep+device")
    want = {k: v * epochs * S for k, v in want.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    v = getattr(m, "packed_kernel_", None) if want_v else None
    phase(what, f"{X.shape}, {N} interactions, S={S}: fit wall {wall:.2f} s"
          f" (incl. once-per-fit prep), peak device memory "
          f"{peak / 2**30:.3f} GiB"
          + (f" (reckoned bound {reckon / 2**30:.3f} GiB)" if reckon else "")
          + f", {f'pipeline v{v}' if want_v else 'wide engine'}, last loss "
          f"{m.last_loss:.6f}, launches {launches}")
    if v != want_v or launches != want:
        raise AssertionError(f"{what}: pipeline {v}, launches {launches}, "
                             f"expected {want_v}, {want}")
    if reckon is not None and peak > reckon:
        raise AssertionError(f"{what}: peak device memory above the "
                             "reckoned bound")
    if probe.calls != epochs:
        raise AssertionError("the device probe did not run every epoch")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()
            and np.isfinite(m.H).all()):
        raise AssertionError("non-finite loss or tables")
    if m.W.shape != (X.shape[0], K) or m.H.shape != (X.shape[1], K):
        raise AssertionError("tables of the wrong shape")
    return launches


def bpr_wide(X, dev):
    """bpr-wide: WIDE_EPOCHS epochs of ``BPR(num_components=256)`` at
    ML-20M shapes through the public ``fit`` (the wide engine): each
    count-lane accumulation once a step, no other kernel; peak device
    memory under the reckoned bound: the tables and their Adam states,
    the uploaded static and epoch streams, and the eager step's
    temporaries, ten (B, Kp) f32 buffers (the gathers, SW, Q, their
    reorders and the sample math's transients) and four (rw, Kp + 128)
    ones (the accumulation and the optimizer update's)."""
    from cymf_tpu_torch.ops import wide_epoch as we
    K = WIDE_K
    Kp = we.kp_width(K)
    rw, rh = we.wide_rows(U, WIDE_WROWS), we.wide_rows(I, WIDE_WROWS)
    S = -(-X.count_nonzero() // BATCH)
    windows = 2 * S * (rw + 2 * rh) // WIDE_WROWS * 4
    streams = S * BATCH * (4 * 8 + 3) + windows   # 8 int32 + 3 uint8 a sample
    reckon = (3 * (rw + rh) * Kp * 4 + streams + 10 * BATCH * Kp * 4
              + 4 * rw * (Kp + 128) * 4)
    return bpr_fit(X, dev, WIDE_EPOCHS, "bpr-wide", None,
                   dict.fromkeys(WIDE_KERNELS, 1), K=K, reckon=reckon)


def wide_quickstart(dev):
    """wide-quickstart: ``BPR(num_components=128)`` (the wide engine) on
    the quickstart data, as the JAX package's wide learning test sets it
    (lr 0.05, no weight decay, batch 1024), 5 epochs: test DCG@5 must beat
    an untrained model's by 0.1, each count-lane accumulation once a
    step."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.ops import _kernels

    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    kw = dict(num_components=128, learning_rate=0.05, weight_decay=0.0,
              batch_size=1024, device=dev)
    m0 = ct.BPR(**kw)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.BPR(**kw)
    _kernels.reset_launches()
    m.fit(d.train, num_epochs=5, verbose=False)
    launches = dict(_kernels.launches)
    res = test.evaluate(m.W, m.H)
    n = 5 * -(-m._samples_per_epoch // 1024)
    phase("wide-quickstart", f"K=128: test {res}; untrained DCG@5 "
          f"{base:.4f}; last loss {m.last_loss:.4f}; launches {launches}")
    if launches != dict.fromkeys(WIDE_KERNELS, n):
        raise AssertionError(f"wide-quickstart: launches {launches}, "
                             f"expected {n} of each wide accumulation")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError("the wide quickstart did not learn")


def v6_against_v4(dev):
    """bpr-v6: ``packed_bpr_epoch(kernel_v=6)`` for EPOCHS epochs on the
    ml-1m streams at ``wrows`` 512 (the JAX package's default, which v6
    needs), held against ``kernel_v=4`` on the same streams from the same
    init under sgd (lr 0.05): tables within rtol 1e-4, atol 1e-5 (float32
    sums in another order through 18 steps), the mean loss within 1e-5
    relative.  Returns v6's launches."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.packed_epoch import (make_packed_optimizer,
                                                 packed_bpr_epoch,
                                                 prep_epoch)
    K, wrows = 20, 512
    X1 = ml1m_matrix()
    N1 = X1.count_nonzero()
    coo = X1.tocoo()
    keys = np.sort(coo.row.astype(np.int64) * ML1M_I + coo.col)
    u2, i2, rw, rh, prep = ml1m_streams(X1, K, wrows)
    winw, wstart, si, rowsi, wini, cs, cn, v = prep
    if v != 6:
        raise AssertionError(f"the ml-1m stream at wrows 512 takes v{v}")
    S = u2.shape[0]

    def put(*arrays):       # copies: the epochs update the tables in place
        return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]

    static = put(u2, i2, si, rowsi, wini)
    blocks = put(winw, wstart, cs, cn)
    epochs = [put(*prep_epoch(np.random.default_rng((1234, e)), u2, i2,
                              keys, ML1M_U, ML1M_I, K, rh, wrows))
              for e in range(EPOCHS)]
    rng = np.random.default_rng(0)
    W0 = pk.pack_array(rng.uniform(-0.1, 0.1, (ML1M_U, K)) / K, K, wrows)
    H0 = pk.pack_logical(rng.uniform(-0.1, 0.1, (ML1M_I, K)) / K, K, wrows)
    out = {}
    for kv in (6, 4):
        Wp, Hp = put(W0, H0)
        opt = make_packed_optimizer("sgd", V6_LR)
        ow, oh = opt.init(Wp), opt.init(Hp)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for e in range(EPOCHS):
            loss = packed_bpr_epoch(
                Wp, Hp, ow, oh, *static, *epochs[e], *blocks, N1,
                opt_name="sgd", lr=V6_LR, weight_decay=0.01, K=K, rw=rw,
                rh=rh, wrows_w=wrows, wrows_h=wrows, kernel_v=kv)
        torch.cuda.synchronize(dev)
        out[kv] = (Wp, Hp, float(loss), dict(_kernels.launches),
                   time.perf_counter() - t0)
    n = EPOCHS * S
    for kv, want in ((6, {"bpr_block_step_v6": n, "sorted_accum_dual": n}),
                     (4, {"bpr_sample_phase": n, "sorted_accum": n,
                          "sorted_accum_dual": n})):
        if out[kv][3] != want:
            raise AssertionError(f"kernel_v={kv}: launches {out[kv][3]}, "
                                 f"expected {want}")
    e_w = close(out[6][0], out[4][0], 1e-4, 1e-5, "v6 vs v4 W")
    e_h = close(out[6][1], out[4][1], 1e-4, 1e-5, "v6 vs v4 H")
    e_l = close(torch.tensor(out[6][2]), torch.tensor(out[4][2]), 1e-5, 0.0,
                "v6 vs v4 loss")
    phase("bpr-v6", f"{EPOCHS} sgd epochs of {S} steps on the ml-1m streams "
          f"at wrows 512: v6 {out[6][4]:.3f} s, v4 {out[4][4]:.3f} s "
          f"(uploaded streams, synchronised); W max abs {e_w[0]:.3e} rel "
          f"{e_w[1]:.3e}, H max abs {e_h[0]:.3e} rel {e_h[1]:.3e} (limit "
          f"rtol 1e-4, atol 1e-5); loss {out[6][2]:.6f} vs {out[4][2]:.6f} "
          f"(rel {e_l[1]:.3e}); launches v6 {out[6][3]}")
    return out[6][3]


def pipeline_fits(X, dev):
    """The v5, v6, v7 and v8 pipelines through their main paths; returns
    each kernel's launches there."""
    from cymf_tpu_torch.ops import packed_epoch as tpe

    launches = bpr_fit(ml1m_matrix(), dev, EPOCHS, "bpr-ml1m", 5,
                       {"bpr_sample_phase_v5": 1, "sorted_accum": 1,
                        "sorted_accum_dual": 1})
    out = {"bpr_sample_phase_v5": launches["bpr_sample_phase_v5"]}
    out["bpr_block_step_v6"] = v6_against_v4(dev)["bpr_block_step_v6"]
    with forced_kernel("7"):
        launches = bpr_fit(X, dev, 1, "bpr-v7", 7,
                           {"bpr_range_step_v7": 1, "sorted_accum_dual": 1})
    out["bpr_range_step_v7"] = launches["bpr_range_step_v7"]
    # the v8 step's item-side accumulation, recorded on the fit's first
    # step and checked after it (outside the launch count)
    pool = {}

    def pool_fit():
        pool["launches"] = bpr_fit(X, dev, 2, "bpr-pool", 8,
                                   {"bpr_pool_step_v8": 1, "sorted_accum": 1},
                                   neg_pool=POOL_P)

    (args, kw), = record_calls(tpe, {"sorted_accum": 1},
                               pool_fit)["sorted_accum"]
    check_sorted_accum(args, kw, "bpr-pool step 0, item side (v8)")
    del args
    out["bpr_pool_step_v8"] = pool["launches"]["bpr_pool_step_v8"]
    quickstart(dev, neg_pool=128)
    return out


def first_wmf_block(X, dev):
    """``A = A0 + (c-1) sub^T sub`` of the first standard-form user chunk
    of the WMF d=256 fit at its first half-sweep, ``(C, 256, 256)``: the
    port's own init, chunks and Woodbury cap."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models.wmf import woodbury_max_p
    from cymf_tpu_torch.ops import als

    m = ct.WMF(num_components=ALS_K, device=dev)
    m._ensure_tables(*X.shape)
    cap = woodbury_max_p(ALS_K, m.weight, m.weight_decay,
                         als.resolve_chol_solver("cholesky", ALS_K, dev))
    ch = next(c for c in als.build_chunks(X, m.chunk_size, X.shape[0],
                                          num_components=ALS_K)
              if c.idx_pad.shape[1] > cap)
    Y = torch.from_numpy(m.H.astype(np.float32)).to(dev)
    sub = als.gather_rows(Y, torch.from_numpy(ch.idx_pad).to(dev),
                          torch.from_numpy(ch.valid).to(dev))
    A0 = Y.T @ Y + m.weight_decay * torch.eye(ALS_K, device=dev)
    return torch.baddbmm(A0.expand(sub.shape[0], -1, -1), sub.mT, sub,
                         alpha=m.weight - 1.0), ch.idx_pad.shape[1]


def check_chol(X, dev):
    """Phase 3 for the batched Cholesky: kernel against plain version on
    diagonal blocks of the WMF d=256 main path, read in place as the
    blocked solve reads them.  Limits: |dL| <= 1e-4 max|L| and
    |Linv L - I| <= 1e-3."""
    from cymf_tpu_torch.ops import chol_kernel as ck

    A, P = first_wmf_block(X, dev)
    out = None
    for what, blk in (("main path", A[:, :64, :64]),
                      ("C=1", A[:1, :64, :64]),
                      ("C=262", A[:262, :64, :64]),
                      ("B=128", A[:, :128, :128])):
        B = blk.shape[-1]
        L, Linv = ck.chol_inv_batched(blk, B)
        Lp, _ = ck.chol_inv_batched_plain(blk)
        torch.cuda.synchronize()
        if not (torch.isfinite(L).all() and torch.isfinite(Linv).all()):
            raise AssertionError(f"chol_inv_batched {what}: non-finite")
        err = float((L.double() - Lp.double()).abs().max())
        lim = 1e-4 * float(Lp.abs().max())
        eye = torch.eye(B, dtype=torch.float64, device=dev)
        inv_err = float((Linv.double() @ Lp.double() - eye).abs().max())
        upper = bool((L.triu(1) != 0).any() or (Linv.triu(1) != 0).any())
        ms = time_ms(lambda: ck.chol_inv_batched(blk, B))
        lms = loop_ms(lambda: ck.chol_inv_batched(blk, B))
        pms = time_ms(lambda: ck.chol_inv_batched_plain(blk))
        # A's lower triangle read (the kernel reads no other), L and Linv
        # written; B^3 / 3 operations for the factor and as many for the
        # inverse, per matrix
        C = blk.shape[0]
        b = bound((C * B * (B + 1) // 2 + 2 * C * B * B) * 4,
                  C * 2 * B ** 3 / 3)
        phase("kernels", f"chol_inv_batched {what} {tuple(blk.shape)} "
              f"(first standard user chunk, P={P}): max abs dL {err:.3e} "
              f"(limit {lim:.3e}), |Linv L - I| {inv_err:.3e} (limit "
              f"1e-3); {ms:.4f} ms a call, {lms:.4f} in a loop (bound "
              f"{b['bound_ms']:.4f}) vs plain {pms:.4f} ms "
              f"(cholesky_ex + solve_triangular)")
        if err > lim or inv_err > 1e-3 or upper:
            raise AssertionError(f"chol_inv_batched {what} disagrees")
        if out is None:
            # no single PyTorch call computes both factors: the library
            # yardstick is the plain version's two calls
            out = dict(max_abs_err=err, ms=ms, loop_ms=lms, plain_ms=pms,
                       **b, library_ms=pms,
                       library_call="cholesky_ex + solve_triangular "
                                    "(two calls)")
    return out


def _close_tables(got, want, what):
    for g, w, name in zip(got, want, ("W", "H", "mu")):
        close(torch.from_numpy(np.asarray(g)), torch.from_numpy(
            np.asarray(w)), ALS_TOL["rtol"], ALS_TOL["atol"],
            f"{what} {name}")


def als_quickstart(dev):
    """Phase 6: WMF and ExpoMF d=128 on the card, through the kernel and
    against the plain diagonal factor."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.ops import _kernels

    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    fits = {}
    saved = os.environ.pop("CYMF_TPU_ALS_CHOL", None)
    try:
        for mode in ("auto", "blocked"):
            os.environ["CYMF_TPU_ALS_CHOL"] = mode
            for name, make, epochs in (
                    ("WMF", lambda: ct.WMF(128, weight_decay=20.0,
                                           device=dev), 5),
                    ("ExpoMF", lambda: ct.ExpoMF(128, weight_decay=1.0,
                                                 device=dev), 3)):
                m = make()
                _kernels.reset_launches()
                m.fit(d.train, num_epochs=epochs, verbose=False)
                n = _kernels.launches["chol_inv_batched"]
                if (n > 0) != (mode == "auto"):
                    raise AssertionError(f"{name} {mode}: {n} Cholesky "
                                         "kernel launches")
                fits[name, mode] = (m, n)
    finally:
        os.environ.pop("CYMF_TPU_ALS_CHOL")
        if saved is not None:
            os.environ["CYMF_TPU_ALS_CHOL"] = saved
    m0 = ct.WMF(128, device=dev)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    wmf, n = fits["WMF", "auto"]
    res = test.evaluate(wmf.W, wmf.H)
    phase("als-quickstart", f"WMF d=128 test {res}; untrained DCG@5 "
          f"{base:.4f}; {n} kernel launches; chunks {wmf.chunks_}")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError("WMF d=128 did not learn")
    _close_tables((wmf.W, wmf.H), (fits["WMF", "blocked"][0].W,
                                   fits["WMF", "blocked"][0].H),
                  "WMF kernel vs plain diagonal")
    e, n = fits["ExpoMF", "auto"]
    ep = fits["ExpoMF", "blocked"][0]
    if not np.isfinite(e.mu).all():
        raise AssertionError("ExpoMF mu is not finite")
    _close_tables((e.W, e.H, e.mu), (ep.W, ep.H, ep.mu),
                  "ExpoMF kernel vs plain diagonal")
    phase("als-quickstart", f"ExpoMF d=128 test DCG@5 "
          f"{test.evaluate(e.W, e.H)['DCG@5']:.4f}; {n} kernel launches; "
          "WMF and ExpoMF match the plain diagonal within rtol "
          f"{ALS_TOL['rtol']}, atol {ALS_TOL['atol']}")


def wmf_full_width(X, dev):
    """Phase 7: WMF d=256 at ML-20M shapes through the public ``fit``."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    m = ct.WMF(num_components=ALS_K, device=dev)
    probe = _DeviceProbe(m)
    U, I = X.shape
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m.fit(X, num_epochs=ALS_EPOCHS, valid_evaluator=probe, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    for e, sec in enumerate(m.epoch_times_):
        phase("wmf", f"epoch {e}: {sec:.3f} s, {X.nnz / sec:.4e} int/s")
    c = m.chunks_
    # reckoned bound: both tables, two gathered (C, P, K) buffers (the
    # gather and its masked copy; build_chunks caps one at 2^29 / K
    # index entries, 2 GiB) and two (C, K, K) ones (A and its factor)
    gather = min(1 << 25, max((1 << 29) // ALS_K, 1 << 16)) * ALS_K * 4
    reckon = ((U + I) * ALS_K * 4 + 2 * gather
              + 2 * m.chunk_size * ALS_K ** 2 * 4)
    phase("wmf", f"fit wall {wall:.2f} s; host build_chunks "
          f"{c['build_s']:.3f} s; chunks W {c['W']} H {c['H']}; "
          f"woodbury_max_p_ {m.woodbury_max_p_}; peak device memory "
          f"{peak / 2**30:.3f} GiB (reckoned bound {reckon / 2**30:.3f} "
          f"GiB: tables + 2 gathered chunks + 2 (C, K, K)); launches "
          f"{launches}")
    if peak > reckon:
        raise AssertionError("peak device memory above the reckoned bound")
    std = c["W"]["standard"] + c["H"]["standard"]
    want = ALS_EPOCHS * (ALS_K // 64) * std
    if launches.get("chol_inv_batched", 0) != want:
        raise AssertionError(f"chol_inv_batched launched "
                             f"{launches.get('chol_inv_batched', 0)} times, "
                             f"expected {want}")
    if probe.calls != ALS_EPOCHS:
        raise AssertionError("the device probe did not run every epoch")
    if m.W.shape != (U, ALS_K) or m.H.shape != (I, ALS_K):
        raise AssertionError("tables of the wrong shape")
    if not (np.isfinite(m.W).all() and np.isfinite(m.H).all()):
        raise AssertionError("non-finite tables")
    return launches


def record_calls(module, keep, run):
    """Runs ``run()`` with the first ``keep[name]`` calls of each
    ``module.<name>`` recording clones of their arguments before they go
    through; returns ``{name: [(args, kwargs), ...]}``."""
    got = {name: [] for name in keep}
    origs = {name: getattr(module, name) for name in keep}

    def recorder(name):
        def call(*args, **kw):
            if len(got[name]) < keep[name]:
                got[name].append((tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args), kw))
            return origs[name](*args, **kw)
        return call

    for name in keep:
        setattr(module, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in origs.items():
            setattr(module, name, fn)
    for name, n in keep.items():
        if len(got[name]) < n:
            raise AssertionError(f"{name} ran {len(got[name])} times, "
                                 f"expected {n}")
    return got


def check_glove_sample(Du, Dx, Kp, what):
    """Phase 3 for the GloVe/RelMF sample kernel at one main-path shape.
    Limits: SW and Q rtol 1e-5, atol 1e-6; the loss relative 1e-5."""
    from cymf_tpu_torch.ops import glove_epoch as ge
    from cymf_tpu_torch.ops import packed as pk

    SW, Q, loss = ge.glove_sample_phase(Du, Dx, Kp=Kp)
    SWp, Qp, lossp = ge.glove_sample_phase_plain(Du, Dx, Kp=Kp)
    torch.cuda.synchronize()
    e_sw = close(SW, SWp, 1e-5, 1e-6, f"SW {what}")
    e_q = close(Q, Qp, 1e-5, 1e-6, f"Q {what}")
    e_l = close(loss, lossp, 1e-5, 0.0, f"loss {what}")
    def kernel():
        return ge.glove_sample_phase(Du, Dx, Kp=Kp)

    ms = time_ms(kernel)
    lms = loop_ms(kernel)
    split = device_split(kernel)
    pms = time_ms(lambda: ge.glove_sample_phase_plain(Du, Dx, Kp=Kp))
    live = int((Q[:, Kp] != 0).sum())
    phase("kernels", f"glove_sample_phase {what} (B={Du.shape[0]}, Kp={Kp},"
          f" {live} live rows): SW max abs {e_sw[0]:.3e} rel {e_sw[1]:.3e};"
          f" Q max abs {e_q[0]:.3e} rel {e_q[1]:.3e}; loss {float(loss):.6f}"
          f" vs {float(lossp):.6f} (rel {e_l[1]:.3e}); {ms:.4f} ms a call, "
          f"{lms:.4f} in a loop, device {sum(split.values()):.4f} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f") vs plain {pms:.4f} ms")
    # Du and Dx read, SW and Q written; per row the slot extraction and
    # placement (2 x 128 x slots) and ~12 elementwise operations a lane
    B = Du.shape[0]
    return dict(max_abs_err=max(e_sw[0], e_q[0]), ms=ms, loop_ms=lms,
                device_ms=sum(split.values()), plain_ms=pms,
                **bound(4 * B * 128 * 4,
                        B * 128 * (2 * pk.num_slots(Kp) + 12)),
                library_ms=None)


def accum_against_library(args, kw, what, reps: int = 20) -> dict:
    """The single-stream accumulation (#2, or #2w with ``count_lanes``) at
    one call: kernel against plain, the payload within 1e-5 max|plain|,
    with ``count_lanes`` the count lane and the 127 unused lanes exact;
    then the times of the kernel and of the library calls that compute the
    same function (``index_add_`` of the live rows into a zeroed buffer,
    and ``bincount`` for the counts), each as :func:`time_ms` and
    :func:`loop_ms` give them.  Uses only what every version of the
    wrapper has, so that ``accum_timing.py`` times older checkouts with
    it."""
    from cymf_tpu_torch.ops import sorted_accum as sa

    rows, g = args[0].reshape(-1), args[1]
    r_pad, width = kw["r_pad"], g.shape[1]
    counts = kw.get("count_lanes", False)
    got = sa.sorted_accum(*args, **kw)
    want = sa.sorted_accum_plain(*args, **kw)
    torch.cuda.synchronize()
    limit = 1e-5 * float(want[:, :width].abs().max())
    e = close(got[:, :width], want[:, :width], 0.0, limit,
              f"sorted_accum {what}")
    close(got[:, width:], want[:, width:], 0.0, 0.0,
          f"sorted_accum {what}, count granule")
    keep = (rows >= 0) & (rows < r_pad)
    live_rows, live_g = rows[keep].long(), g[keep]

    def lib():
        out = torch.zeros_like(want)
        out[:, :width].index_add_(0, live_rows, live_g)
        if counts:
            out[:, width] = torch.bincount(live_rows, minlength=r_pad)
        return out

    close(lib(), want, 0.0, limit, f"library call, {what}")

    def kernel():
        return sa.sorted_accum(*args, **kw)

    return dict(max_abs_err=e[0], max_rel_err=e[1], limit=limit,
                live=int(keep.sum()), ms=time_ms(kernel, reps),
                loop_ms=loop_ms(kernel, reps),
                **accum_bound(args, r_pad, got.shape[1]),
                library_ms=time_ms(lib, reps),
                library_loop_ms=loop_ms(lib, reps))


def dual_against_plain(args, kw, what, reps: int = 20) -> dict:
    """The dual accumulation (#3, or #3w with ``count_lanes``) at one
    call: kernel against plain, the payload within 1e-5 max|plain|, with
    ``count_lanes`` the count lane and the 127 unused lanes exact; then
    the kernel's times: :func:`time_ms`, :func:`loop_ms` and its device
    time a call by CUDA kernel (:func:`device_split`, ``split_ms``; its
    sum is ``device_ms``).  No single PyTorch call computes the function.
    Uses only what every version of the wrapper has, so that
    ``accum_timing.py`` times older checkouts with it."""
    from cymf_tpu_torch.ops import sorted_accum as sa

    width = args[1].shape[1]
    got = sa.sorted_accum_dual(*args, **kw)
    want = sa.sorted_accum_dual_plain(*args, **kw)
    torch.cuda.synchronize()
    limit = 1e-5 * float(want[:, :width].abs().max())
    e = close(got[:, :width], want[:, :width], 0.0, limit,
              f"sorted_accum_dual {what}")
    close(got[:, width:], want[:, width:], 0.0, 0.0,
          f"sorted_accum_dual {what}, count granule")

    def kernel():
        return sa.sorted_accum_dual(*args, **kw)

    split = device_split(kernel, reps)
    return dict(max_abs_err=e[0], max_rel_err=e[1], limit=limit,
                ms=time_ms(kernel, reps), loop_ms=loop_ms(kernel, reps),
                device_ms=sum(split.values()), split_ms=split,
                **accum_bound(args, kw["r_pad"], got.shape[1]))


def check_dual(args, kw, what):
    """Phase 3 for the dual accumulation at one main-path call:
    :func:`dual_against_plain`, two calls equal to the bit, the plain
    version's time and the launch's grid, printed."""
    from cymf_tpu_torch.ops import sorted_accum as sa

    n_i, width, n_j = args[1].shape[0], args[1].shape[1], args[5].shape[0]
    r_pad, counts = kw["r_pad"], kw.get("count_lanes", False)
    res = dual_against_plain(args, kw, what)
    limit, max_rel = res.pop("limit"), res.pop("max_rel_err")
    split = res.pop("split_ms")
    a = sa.sorted_accum_dual(*args, **kw)
    b = sa.sorted_accum_dual(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"sorted_accum_dual {what}: two calls differ")
    res["plain_ms"] = time_ms(lambda: sa.sorted_accum_dual_plain(*args,
                                                                 **kw))
    res["library_ms"] = None
    plan = sa.dual_plan(n_i, n_j, r_pad, width)
    live = sum(int(((r.reshape(-1) >= 0) & (r.reshape(-1) < r_pad)).sum())
               for r in (args[0], args[4]))
    name = "sorted_accum_dual_wide" if counts else "sorted_accum_dual"
    phase("kernels", f"{name} {what} (B={n_i} + {n_j}, width {width}"
          f"{' + count granule' if counts else ''}, r_pad {r_pad}, {live} "
          f"live samples): j then i, {plan['blocks_j']} + "
          f"{plan['blocks_i']} CTAs ({plan['parts_j']} + {plan['parts_i']} "
          f"parts of {plan['part']}); max abs "
          f"{res['max_abs_err']:.3e} (limit {limit:.3e} = 1e-5 max|plain|"
          f"{', count granule exact' if counts else ''}), max rel "
          f"{max_rel:.3e}, two calls equal to the bit; {res['ms']:.4f} ms a "
          f"call, {res['loop_ms']:.4f} ms in a loop, device "
          f"{res['device_ms']:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"); plain {res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} "
          "ms")
    return res


def check_sorted_accum(args, kw, what):
    """Phase 3 for the single-stream accumulation at one main-path call:
    :func:`accum_against_library`, the plain version's time, the launch's
    grid and the stream's runs
    (:func:`~cymf_tpu_torch.ops.sorted_accum.segment_twin`, which also
    holds the stream to the kernel's precondition)."""
    from cymf_tpu_torch.ops import sorted_accum as sa

    rows, g = args[0].reshape(-1), args[1]
    r_pad, width = kw["r_pad"], g.shape[1]
    counts = kw.get("count_lanes", False)
    res = accum_against_library(args, kw, what)
    limit, live = res.pop("limit"), res.pop("live")
    max_rel = res.pop("max_rel_err")
    res["plain_ms"] = time_ms(lambda: sa.sorted_accum_plain(*args, **kw))
    plan = sa.segment_plan(rows.numel(), r_pad, width)
    twin = sa.segment_twin(rows.cpu().numpy(), r_pad, plan["part"],
                           plan["zero_gap"])
    phase("kernels", f"{'sorted_accum_wide' if counts else 'sorted_accum'} "
          f"{what} (B={g.shape[0]}, width {width}"
          f"{' + count granule' if counts else ''}, r_pad {r_pad}, {live} "
          f"live samples): {plan['blocks']} CTAs of {plan['share']} "
          f"samples ({plan['parts']} parts of {plan['part']}); "
          f"{twin['runs']} runs, {twin['joined']} joined across parts, the "
          f"longest {twin['longest']} samples, the longest join "
          f"{twin['walk']} parts; max abs {res['max_abs_err']:.3e} (limit "
          f"{limit:.3e} = 1e-5 max|plain|"
          f"{', count granule exact' if counts else ''}), max rel "
          f"{max_rel:.3e}; {res['ms']:.4f} ms a call, {res['loop_ms']:.4f} "
          f"ms in a loop; plain {res['plain_ms']:.4f} ms; "
          f"{'index_add_ + bincount' if counts else 'index_add_'} "
          f"{res['library_ms']:.4f} ms a call, {res['library_loop_ms']:.4f}"
          f" ms in a loop; bound {res['bound_ms']:.4f} ms")
    return res


def relmf_ml20m_state(X, dev):
    """The state of a device-prep RelMF fit at ML-20M shapes, built as
    ``RelMF.fit`` builds it: the model's init packed, ``1 / max(p_i, M)``
    on lane K of the item table, Adam states, the pair hash set of X's
    distinct pairs on the card."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
    from cymf_tpu_torch.ops.packed_epoch import make_packed_optimizer

    K = RELMF_K
    m = ct.RelMF(K, batch_size=BATCH, device=dev)
    m._ensure_tables(U, I)
    rw = pk.packed_rows(U, K, multiple=WROWS)
    rh = pk.logical_rows(I, multiple=WROWS)
    col_mean = np.asarray(X.mean(axis=0)).flatten()
    props = np.maximum(col_mean / col_mean.max(), 1e-5) ** 0.5
    Wp = torch.from_numpy(pk.pack_array(m.W, K, multiple=WROWS)).to(dev)
    Hp = torch.from_numpy(pk.pack_logical(m.H, K, multiple=WROWS)).to(dev)
    Hp[:I, K] = torch.from_numpy(
        (1.0 / np.maximum(props, m.clip_value)).astype(np.float32)).to(dev)
    opt = make_packed_optimizer(m.optimizer, m.learning_rate)
    coo = X.tocoo()
    t0 = time.perf_counter()
    hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
    build_s = time.perf_counter() - t0
    kw = dict(B=BATCH, num_users=U, num_items=I, opt_name=m.optimizer,
              lr=m.learning_rate, weight_decay=m.weight_decay, K=K, rw=rw,
              rh=rh, wrows_w=WROWS, wrows_h=WROWS)
    return dict(Wp=Wp, Hp=Hp, ow=opt.init(Wp), oh=opt.init(Hp), hs=hs,
                kw=kw, hs_build_s=build_s)


def glove_matrix(V: int = GLOVE_V, nnz: int = GLOVE_NNZ):
    """A JAX GloVe bench stream's co-occurrence matrix (``_glove_stream``):
    ``nnz`` uniform (row, col) draws over ``V`` words with counts in
    [1, 50); by default the ``glove_packed`` stream, 50,000 words and
    3,000,000 draws."""
    from scipy import sparse
    rng = np.random.default_rng(0)
    r = rng.integers(0, V, nnz)
    c = rng.integers(0, V, nnz)
    return sparse.csr_matrix(
        (rng.integers(1, 50, nnz).astype(np.float64), (r, c)), shape=(V, V))


def check_glove_kernels(relmf, G, dev):
    """Phase 3 for the sample kernel and both accumulations of a step: step
    0 of the device-prep RelMF epoch at ML-20M (the port's own draws and
    labels, on a copy of the state) and step 0 of the GloVe fit on the
    ``glove_packed`` stream."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import glove_epoch as ge
    from cymf_tpu_torch.ops import relmf_epoch as tre

    st = relmf
    keep = {"glove_sample_phase": 1, "sorted_accum": 2}

    def relmf_step0():
        tre.packed_relmf_epoch_device(
            st["Wp"].clone(), st["Hp"].clone(),
            {k: v.clone() for k, v in st["ow"].items()},
            {k: v.clone() for k, v in st["oh"].items()}, st["hs"],
            tre.epoch_generator(1234, 0, dev), 1, 1.0, **st["kw"])

    def glove_epoch0():
        np.random.seed(0)
        ct.GloVe(GLOVE_K, batch_size=BATCH, device=dev).fit(G, num_epochs=1)

    out = None
    for module, run, what in ((tre, relmf_step0, "RelMF ML-20M step 0"),
                              (ge, glove_epoch0, "GloVe 50k-word step 0")):
        got = record_calls(module, keep, run)
        (Du, Dx), kw = got["glove_sample_phase"][0]
        res = check_glove_sample(Du, Dx, kw["Kp"], what)
        out = out or res
        for (args, kw), side in zip(got["sorted_accum"], ("W", "H")):
            check_sorted_accum(args, kw, f"{what}, {side} side")
        del got, Du, Dx
    return out


def relmf_ml20m(st, dev):
    """1,000 steps of ``packed_relmf_epoch_device`` (the function the
    device-prep fit calls) at ML-20M shapes: the depth cut of the JAX
    bench's BENCH_SMALL slice, at full width."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import relmf_epoch as tre

    full_steps = -(-U * I // BATCH)
    n_valid = float(full_steps) * BATCH
    args = (st["Wp"], st["Hp"], st["ow"], st["oh"], st["hs"])
    tre.packed_relmf_epoch_device(*args, tre.epoch_generator(1, 0, dev), 20,
                                  n_valid, **st["kw"])        # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    loss = tre.packed_relmf_epoch_device(
        *args, tre.epoch_generator(1234, 0, dev), ML20M_STEPS, n_valid,
        **st["kw"])
    torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    # reckoned bound: the hash set, both tables with two Adam moments
    # each, eight (B, 128) float32 buffers of a step (five live at once:
    # Du, Dx, SW, Q, Q[si]; the level-1 hash probe's row gather before
    # them) and eight table-sized optimizer temporaries
    hs_b = sum(t.numel() * 4 for t in st["hs"])
    tab_b = (st["Wp"].numel() + st["Hp"].numel()) * 4
    reckon = hs_b + 3 * tab_b + 8 * BATCH * 128 * 4 + 8 * tab_b
    ms = 1e3 * sec / ML20M_STEPS
    phase("relmf-ml20m", f"{ML20M_STEPS} steps of B={BATCH} at ({U}, {I}), "
          f"K={RELMF_K}: {ms:.4f} ms/step, {ML20M_STEPS * BATCH / sec:.4e} "
          f"cells/s; full epoch of {full_steps} steps extrapolated "
          f"{full_steps * ms / 1e3:.1f} s (extrapolation, not run); hash "
          f"set {hs_b / 2**20:.1f} MiB built on the host in "
          f"{st['hs_build_s']:.1f} s; peak device memory "
          f"{peak / 2**30:.3f} GiB (state held before the steps "
          f"{held / 2**30:.3f} GiB; reckoned bound {reckon / 2**30:.3f} GiB)"
          f"; loss {float(loss) * n_valid / (ML20M_STEPS * BATCH):.6f} a "
          f"cell; launches {launches}")
    if peak > reckon:
        raise AssertionError("peak device memory above the reckoned bound")
    if launches != {"glove_sample_phase": ML20M_STEPS,
                    "sorted_accum": 2 * ML20M_STEPS}:
        raise AssertionError(f"launches {launches}")
    if not (torch.isfinite(st["Wp"]).all() and torch.isfinite(st["Hp"]).all()
            and np.isfinite(float(loss))):
        raise AssertionError("non-finite tables or loss")
    return ms


def relmf_quickstart(dev):
    """RelMF on the README quickstart's data with device prep: test DCG@5
    must beat an untrained model's by 0.1."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset

    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    kw = dict(num_components=RELMF_K, learning_rate=0.01, weight_decay=1e-4,
              batch_size=8192, device=dev)
    m0 = ct.RelMF(**kw)
    m0.fit(d.train, num_epochs=0)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.RelMF(**kw)
    m.fit(d.train, num_epochs=20)
    res = test.evaluate(m.W, m.H)
    phase("relmf-quickstart", f"test {res}; untrained DCG@5 {base:.4f}; "
          f"prep {m.prep_backend_}; last loss {m.last_loss:.6f}")
    if m.prep_backend_ != "device-torch":
        raise AssertionError("the fit did not take device prep")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError("the RelMF quickstart did not learn")


def relmf_full(dev):
    """3 device-prep epochs of the public RelMF fit at the JAX ``relmf``
    bench mode's shapes (ml-1m 6040 x 3706, every cell an epoch)."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.ops import _kernels

    d = SyntheticImplicitDataset(num_user=6040, num_item=3706, rank=8,
                                 density=0.04, seed=0)
    m = ct.RelMF(num_components=RELMF_K, batch_size=BATCH, device=dev)
    probe = _DeviceProbe(m)
    S = -(-6040 * 3706 // BATCH)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m.fit(d.train, num_epochs=RELMF_EPOCHS, valid_evaluator=probe)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    for e, st in enumerate(m.epoch_times_):
        phase("relmf-full", f"epoch {e}: device {st['device_s']:.3f} s, "
              f"{m._samples_per_epoch / st['device_s']:.4e} cells/s")
    phase("relmf-full", f"fit wall {wall:.2f} s; prep {m.prep_backend_}; "
          f"last loss {m.last_loss:.6f}; launches {launches}, S={S}")
    want = {"glove_sample_phase": RELMF_EPOCHS * S,
            "sorted_accum": 2 * RELMF_EPOCHS * S}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if probe.calls != RELMF_EPOCHS or m.prep_backend_ != "device-torch":
        raise AssertionError("the fit left the card or took host prep")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()
            and np.isfinite(m.H).all()):
        raise AssertionError("non-finite loss or tables")
    return launches


def glove_full(G, dev):
    """3 epochs of the public GloVe fit on the ``glove_packed`` stream."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    np.random.seed(0)
    m = ct.GloVe(GLOVE_K, batch_size=BATCH, device=dev)
    _kernels.reset_launches()
    m.fit(G, num_epochs=GLOVE_EPOCHS)
    launches = dict(_kernels.launches)
    S = -(-G.nnz // BATCH)
    for e, sec in enumerate(m.epoch_times_):
        phase("glove-full", f"epoch {e}: {sec:.3f} s, {G.nnz / sec:.4e} "
              "triples/s")
    ones = all(bool((c == 1).all()) for c in m.constant_columns_)
    phase("glove-full", f"{G.nnz} triples, S={S}; once-per-fit prep "
          f"{m.prep_s_:.2f} s; last loss {m.last_loss:.6f}; constant "
          f"columns exactly one: {ones}; launches {launches}")
    if launches != {"glove_sample_phase": GLOVE_EPOCHS * S,
                    "sorted_accum": 2 * GLOVE_EPOCHS * S}:
        raise AssertionError(f"launches {launches}")
    if not ones:
        raise AssertionError("a constant-one column moved")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()):
        raise AssertionError("non-finite loss or embeddings")


def ml100k_matrix():
    """55,296 distinct interactions (the JAX ``bpr_pallas`` bench's N) in
    a 943 x 1682 matrix, drawn without replacement from
    ``default_rng(0)``."""
    from scipy import sparse
    keys = np.random.default_rng(0).choice(ML100K_U * ML100K_I, ML100K_N,
                                           replace=False)
    return sparse.csr_matrix(
        (np.ones(ML100K_N), (keys // ML100K_I, keys % ML100K_I)),
        shape=(ML100K_U, ML100K_I))


def pallas_models(dev):
    """Builders of the three sequential-engine trainers at full width:
    BPR and RelMF d=20 (Adam; BPR at the bench's lr 0.01), GloVe d=50."""
    import cymf_tpu_torch as ct
    return {
        "bpr_pallas_epoch": lambda: ct.BPR(
            PALLAS_K, learning_rate=0.01, weight_decay=0.01,
            optimizer="adam", engine="pallas", device=dev),
        "relmf_pallas_epoch": lambda: ct.RelMF(PALLAS_K, engine="pallas",
                                               device=dev),
        "glove_pallas_epoch": lambda: ct.GloVe(GLOVE_K, engine="pallas",
                                               device=dev)}


def seq_launches(X, G, dev):
    """``{name: (epoch launch, main-path launch)}``: the arguments of each
    sequential kernel's first launch in a one-epoch public fit at full
    width (X for BPR and RelMF, G for GloVe), and of the launch that
    :func:`pallas_full`'s launch count counts (BPR's: the whole 10-epoch
    fit without a validator; the others': an epoch), recorded before the
    launches run."""
    from cymf_tpu_torch.ops import pallas_engine as pe
    make = pallas_models(dev)

    def run():
        make["bpr_pallas_epoch"]().fit(X, num_epochs=1, verbose=False)
        make["bpr_pallas_epoch"]().fit(X, num_epochs=10, verbose=False)
        make["relmf_pallas_epoch"]().fit(X, num_epochs=1)
        np.random.seed(0)
        make["glove_pallas_epoch"]().fit(G, num_epochs=1)

    keep = dict.fromkeys(PALLAS_KERNELS, 1)
    keep["bpr_pallas_epoch"] = 2
    got = record_calls(pe, keep, run)
    return {name: (calls[0], calls[-1]) for name, calls in got.items()}


def seq_close(got, want, optimizer, lr, what):
    """The sequential kernels' table limit: rtol 1e-4, atol 1e-5 under sgd
    and adagrad (the dot products' summation order compounding over the
    chain); under adam fewer than 1% of elements outside that and each
    within 2.5 lr (a first touch whose tiny gradient flips sign moves a
    row by +-lr).  Returns (max abs, max rel over |want| > 1e-6,
    elements outside rtol/atol)."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    n_bad = int((err > 1e-5 + 1e-4 * want.abs()).sum())
    max_abs = float(err.max())
    big = want.abs() > 1e-6
    max_rel = float((err[big] / want.abs()[big]).max()) if big.any() else 0.0
    ok = n_bad == 0 if optimizer != "adam" else (
        n_bad < 0.01 * got.numel() and max_abs <= 2.5 * lr)
    if not ok:
        raise AssertionError(f"{what}: {n_bad} of {got.numel()} elements "
                             f"off, max abs {max_abs:.3e} (lr {lr})")
    return max_abs, max_rel, n_bad


# float32 operations of an optimizer step, per element
_OPT_OPS = {"sgd": 2, "adagrad": 6, "adam": 12}


def seq_bound(name, tables, streams, optimizer) -> dict:
    """:func:`bound` of a sequential launch on this run's data: the
    streams read; each row that a kept sample touches read once and
    written once (a masked sample's reads change nothing); per kept
    sample the loss, gradient and optimizer operations over the segment
    width Kp."""
    n_state = {"sgd": 0, "adagrad": 1, "adam": 2}[optimizer]
    row_bytes = tables[0].shape[1] * 4
    Kp = tables[0].shape[1] // (1 + n_state)
    host = [s.reshape(-1).cpu().numpy() for s in streams]
    keep = host[-1] != 0
    if name == "bpr_pallas_epoch":
        rows = [host[0][keep], np.concatenate([host[1][keep],
                                               host[2][keep]])]
        per = 18 * Kp + 3 * Kp * _OPT_OPS[optimizer] + 10
    else:
        rows = [host[0][keep], host[1][keep]]
        per = (12 if name == "relmf_pallas_epoch" else 8) * Kp \
            + 2 * Kp * _OPT_OPS[optimizer] + 10
    touched = sum(len(np.unique(r)) for r in rows)
    nbytes = sum(s.numel() * s.element_size() for s in streams) \
        + 2 * touched * row_bytes + 4
    return bound(nbytes, int(keep.sum()) * per)


def quickstart_data():
    """The quickstart's synthetic data (600 users x 300 items)."""
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    return SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                    density=0.08, seed=7)


def check_seq_kernels(launches, dev, tag="full width"):
    """Phase 3 for the sequential kernels: each against its plain version
    on the first SEQ_CHUNKS chunks (8,192 samples) of the first launch in
    ``launches``' fit, from the fit's initial parameters, under every
    optimizer it takes and at group 1 and 8.  Limits as
    :func:`seq_close`; the loss within 1e-5 relative; GloVe's
    constant-one columns stay exactly one.  Then each is timed at its
    main-path launch (:func:`seq_launches`; BPR's epoch launch too),
    which must give the same bits twice, beside its bound there, and the
    placement its plan chose is printed.  The JSON's ``ms`` and
    ``bound_ms`` are the main-path launch's; ``plain_ms`` is the plain
    version's once on the 8,192 samples (``plain_samples``; on a whole
    launch it would take tens of minutes), ``slice_ms`` the kernel's
    there."""
    from cymf_tpu_torch.ops import pallas_engine as pe
    spec = {"bpr_pallas_epoch": (pe.bpr_pallas_epoch,
                                 pe.bpr_pallas_epoch_plain, PALLAS_K),
            "relmf_pallas_epoch": (pe.relmf_pallas_epoch,
                                   pe.relmf_pallas_epoch_plain, PALLAS_K),
            "glove_pallas_epoch": (pe.glove_pallas_epoch,
                                   pe.glove_pallas_epoch_plain, GLOVE_K + 2)}
    results = {}
    for name, ((args, kw), main) in launches.items():
        fn, plain, width = spec[name]
        params = [pe.unpack_table(t, width).cpu().numpy() for t in args[:2]]
        streams = [a[:SEQ_CHUNKS].contiguous() for a in args[2:]]
        main_opt = kw.get("optimizer", "adagrad")
        opts = ("sgd", "adagrad", "adam") if "optimizer" in kw \
            else ("adagrad",)
        for opt, group in [(o, g) for o in opts for g in (1, 8)]:
            k2 = dict(kw, group=group)
            if "optimizer" in kw:
                k2["optimizer"] = opt
            base = [pe.pack_table(p, opt, dev) for p in params]
            got = fn(*(t.clone() for t in base), *streams, **k2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(*(t.clone() for t in base), *streams, **k2)
            torch.cuda.synchronize()
            pms = 1e3 * (time.perf_counter() - t0)
            what = f"{name} {tag} {opt} group={group}"
            errs = [seq_close(g, w, opt, kw["lr"], f"{what} {side}")
                    for g, w, side in zip(got[:2], want[:2], "WH")]
            e_l = close(got[2], want[2], 1e-5, 0.0, f"{what} loss")
            scratch = [t.clone() for t in base]
            ms = time_ms(lambda: fn(*scratch, *streams, **k2))
            msg = (f"{what} ({SEQ_CHUNKS} chunks of {streams[0].shape[-1]},"
                   f" tables {tuple(base[0].shape)} {tuple(base[1].shape)}):"
                   f" W max abs {errs[0][0]:.3e} rel {errs[0][1]:.3e} "
                   f"({errs[0][2]} outside rtol/atol), H max abs "
                   f"{errs[1][0]:.3e} rel {errs[1][1]:.3e} ({errs[1][2]}); "
                   f"loss {float(got[2]):.6f} vs {float(want[2]):.6f} (rel "
                   f"{e_l[1]:.3e}); {ms:.4f} ms vs plain {pms:.1f} ms (once)")
            if name == "glove_pallas_epoch":
                ones = bool((got[0][:, GLOVE_K + 1] == 1).all()
                            and (got[1][:, GLOVE_K] == 1).all())
                msg += f"; constant columns exactly one: {ones}"
                if not ones:
                    raise AssertionError("a constant-one column moved")
            phase("kernels", msg)
            if opt == main_opt and group == kw["group"]:
                results[name] = dict(
                    max_abs_err=max(errs[0][0], errs[1][0]), slice_ms=ms,
                    plain_ms=pms, plain_samples=streams[0].numel(),
                    library_ms=None)
        results[name].update(time_seq_launch(name, fn, *main,
                                             f"{tag} main-path launch"))
        if name == "bpr_pallas_epoch":
            results[name]["epoch_ms"] = time_seq_launch(
                name, fn, args, kw, f"{tag} epoch launch")["ms"]
    return results


_PLACEMENTS = {0: "device memory (L2)", 1: "the block's shared memory"}


def seq_launch_ms(fn, args, kw, reps: int = 5) -> float:
    """A sequential wrapper ``fn`` at one whole launch: the median of
    ``reps`` CUDA-event timings from ``args``' starting tables (cloned
    once: each timed launch goes on from the tables the last one left)."""
    scratch = [t.clone() for t in args[:2]]
    return time_ms(lambda: fn(*scratch, *args[2:], **kw), reps=reps)


def seq_plan(tables) -> int:
    """The placement the kernel's plan (``cymf_seq_epoch_plan``, which
    the launch applies) chooses for two fused tables."""
    from cymf_tpu_torch.ops import _kernels
    return _kernels.lib().cymf_seq_epoch_plan(
        tables[0].shape[0], tables[1].shape[0], tables[0].shape[1] * 4)


def time_seq_launch(name, fn, args, kw, what="main-path launch") -> dict:
    """A sequential kernel at a whole launch of a fit: the median of 5
    CUDA-event timings from the fit's starting tables, the same bits on
    two calls, its bound and the placement its plan chose, printed.  Where
    the plan keeps the tables in the block's shared memory, the launch is
    also timed with them forced into device memory (``placement_0_ms``),
    which must give the same bits."""
    tables, streams = args[:2], args[2:]
    placement = seq_plan(tables)
    outs = []
    for p in [None, None] + ([0] if placement == 1 else []):
        outs.append(fn(*(t.clone() for t in tables), *streams,
                       _placement=p, **kw))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    if not (same and all(bool(torch.isfinite(t).all()) for t in outs[0])):
        raise AssertionError(f"{name} {what}: two calls (or the placements) "
                             "differ or a value is not finite")
    ms = seq_launch_ms(fn, args, kw)
    n = streams[0].numel()
    opt = kw.get("optimizer", "adagrad")
    b = seq_bound(name, tables, streams, opt)
    res = dict(ms=ms, samples=n, placement=placement, **b)
    msg = (f"{name} {what} ({n} samples, {n // kw['group']} groups of "
           f"{kw['group']}, {opt}, tables {tuple(tables[0].shape)} "
           f"{tuple(tables[1].shape)} in {_PLACEMENTS[placement]}, placement "
           f"{placement}): {ms:.3f} ms, {1e6 * ms / (n // kw['group']):.1f} "
           "ns a group; two calls the same bits")
    if placement == 1:
        res["placement_0_ms"] = seq_launch_ms(fn, args, dict(kw, _placement=0))
        msg += (f"; forced into device memory the same bits, "
                f"{res['placement_0_ms']:.3f} ms")
    phase("kernels", f"{msg}; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    return res


def pallas_quickstart(dev):
    """BPR(engine="pallas") on the quickstart data with validation and
    early stopping must beat an untrained model's test DCG@5 by 0.1."""
    import cymf_tpu_torch as ct

    d = quickstart_data()
    valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                            device=dev)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    kw = dict(num_components=20, learning_rate=0.01, weight_decay=0.01,
              engine="pallas", device=dev)
    m0 = ct.BPR(**kw)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.BPR(**kw)
    m.fit(d.train, num_epochs=30, valid_evaluator=valid, early_stopping=True,
          verbose=False)
    res = test.evaluate(m.W, m.H)
    phase("pallas-quickstart", f"test {res}; untrained DCG@5 {base:.4f}; "
          f"best valid DCG@5 {m.valid_dcg:.4f}; {len(m.epoch_times_)} "
          f"epochs; last loss {m.last_loss:.4f}")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError("the pallas quickstart did not learn")


def pallas_full(X, G, dev):
    """Each sequential engine through the public ``fit`` at full width:
    BPR 10 epochs without a validator (one launch for the whole fit), BPR
    and RelMF 3 epochs with a validator (a launch an epoch), GloVe 3
    epochs.  Returns each kernel's launches on its main path."""
    from cymf_tpu_torch.ops import _kernels
    make = pallas_models(dev)
    out = {}
    for what, name, epochs, validate, want in (
            ("BPR, no validator", "bpr_pallas_epoch", 10, False, 1),
            ("BPR, validator", "bpr_pallas_epoch", PALLAS_EPOCHS, True,
             PALLAS_EPOCHS),
            ("RelMF, validator", "relmf_pallas_epoch", PALLAS_EPOCHS, True,
             PALLAS_EPOCHS),
            ("GloVe", "glove_pallas_epoch", PALLAS_EPOCHS, False,
             PALLAS_EPOCHS)):
        m = make[name]()
        probe = _DeviceProbe(m) if validate else None
        np.random.seed(0)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        if name == "glove_pallas_epoch":
            m.fit(G, num_epochs=epochs)
        elif name == "relmf_pallas_epoch":
            m.fit(X, num_epochs=epochs, valid_evaluator=probe)
        else:
            m.fit(X, num_epochs=epochs, valid_evaluator=probe, verbose=False)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        if name == "glove_pallas_epoch":
            dev_s, n = sum(m.epoch_times_), G.nnz
            ones = all(bool((c == 1).all()) for c in m.constant_columns_)
            extra = f"; constant columns exactly one: {ones}"
            if not ones:
                raise AssertionError("a constant-one column moved")
        else:
            dev_s = sum(e["device_s"] for e in m.epoch_times_)
            n, extra = m._samples_per_epoch, ""
        if name == "bpr_pallas_epoch":
            ref = BENCH_SEQ_CPU_EPOCHS_S
            extra += (f"; against bench.py's CPU reference of {ref} epochs/s"
                      f": {epochs / dev_s / ref:.2f}x on the device alone "
                      f"(bpr_pallas mode's measure), {epochs / wall:.2f} "
                      f"epochs/s and {epochs / wall / ref:.2f}x over the fit"
                      " wall (host sampling and packing included)")
        phase("pallas-full", f"{what}, {epochs} epochs ({n} samples an "
              f"epoch): {1e3 * dev_s / epochs:.3f} ms an epoch on the "
              f"device, {epochs / dev_s:.2f} epochs/s, "
              f"{n * epochs / dev_s:.4e} samples/s; fit wall {wall:.2f} s; "
              f"last loss {m.last_loss:.6f}; launches {launches}{extra}")
        if launches != {name: want}:
            raise AssertionError(f"launches {launches}, expected "
                                 f"{ {name: want} }")
        if validate and probe.calls != epochs:
            raise AssertionError("the device probe did not run every epoch")
        if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()):
            raise AssertionError("non-finite loss or tables")
        out.setdefault(name, launches[name])
    return out


_SCOPES = {"als.woodbury": "Woodbury chunk solves",
           "als.blocked": "panel + substitution products (blocked solve)",
           "als.correction": "correction products (standard form)",
           "als.gather": "gathers (both forms)"}


def profile_wmf(X, dev):
    """``--profile``: device time of one WMF d=256 epoch by part, from
    ``torch.profiler``, with host chunk building beside it.  A kernel
    belongs to the ``annotate`` scope whose span on the device timeline
    holds it; the Cholesky kernel is named apart from its scope."""
    import cymf_tpu_torch as ct
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m = ct.WMF(num_components=ALS_K, device=dev)
    m.fit(X, num_epochs=1, verbose=False)          # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.fit(X, num_epochs=1, verbose=False)
    spans = collections.defaultdict(list)
    kernels = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name in _SCOPES:
            spans[e.name].append(span)
        elif not getattr(e, "is_user_annotation", False):
            kernels.append((e.name, *span))
    for name in spans:
        spans[name] = np.array(sorted(spans[name]))
    if not spans:
        raise AssertionError("the profile holds no device spans of the "
                             "als.* scopes")
    # the sweeps: from the first scope's start to the last one's end
    lo = min(sp[0, 0] for sp in spans.values())
    hi = max(sp[:, 1].max() for sp in spans.values())
    split = collections.Counter()
    busy, last = 0.0, -np.inf
    for name, t0, t1 in sorted(kernels, key=lambda k: k[1]):
        if t1 <= lo or t0 >= hi:
            split["outside the sweeps (uploads, tables to host)"] += \
                (t1 - t0) / 1e3
            continue
        busy += max(t1 - max(t0, last), 0)
        last = max(last, t1)
        if "chol_inv" in name:
            label = "Cholesky kernel"
        else:
            label = "other (Gramian, inverse, scatter, copies)"
            for scope, sp in spans.items():
                i = np.searchsorted(sp[:, 0], t0, side="right") - 1
                if i >= 0 and t1 <= sp[i, 1]:
                    label = _SCOPES[scope]
                    break
        split[label] += (t1 - t0) / 1e3
    total = sum(split.values())
    window = (hi - lo) / 1e3
    lines = [f"one WMF d={ALS_K} epoch at ML-20M shapes, "
             f"{torch.cuda.get_device_name(0)}: epoch {m.epoch_times_[0]:.3f}"
             f" s wall, host build_chunks {m.chunks_['build_s']:.3f} s; "
             f"sweeps span {window:.1f} ms on the device, busy "
             f"{busy / 1e3:.1f} ms of it ({100 * busy / 1e3 / window:.1f}%,"
             f" kernel and copy intervals merged); device time "
             f"{total:.1f} ms in all"]
    for label, ms in split.most_common():
        lines.append(f"  {label}: {ms:.1f} ms ({100 * ms / total:.1f}%)")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wmf_profile.txt").write_text("\n".join(lines) + "\n\n"
                                         + table)
    for line in lines:
        phase("profile", line)
    if not split.get("Cholesky kernel"):
        raise AssertionError("the profile shows no Cholesky kernel")


def profile_relmf(st, dev, ms_step: float, steps: int = 50):
    """``--profile``: device time by kernel of ``steps`` device-prep RelMF
    steps at ML-20M shapes, and the card's busy share of a step against
    the unprofiled ``ms_step`` of phase 4."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cymf_tpu_torch.ops import relmf_epoch as tre

    def run():
        tre.packed_relmf_epoch_device(
            st["Wp"], st["Hp"], st["ow"], st["oh"], st["hs"],
            tre.epoch_generator(7, 0, dev), steps, 1.0, **st["kw"])
        torch.cuda.synchronize(dev)

    run()                                          # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        raise AssertionError("the profile holds no device time")
    busy, last = 0.0, -np.inf
    by_name = collections.Counter()
    for t0, t1, name in spans:
        busy += max(t1 - max(t0, last), 0)
        last = max(last, t1)
        by_name[name[:70]] += (t1 - t0) / 1e3
    busy_step = busy / 1e3 / steps
    lines = [f"{steps} device-prep RelMF steps at ML-20M shapes, "
             f"{torch.cuda.get_device_name(0)}: card busy {busy_step:.3f} "
             f"ms a step (kernel and copy intervals merged) against "
             f"{ms_step:.3f} ms a step unprofiled: idle share "
             f"{100 * max(1 - busy_step / ms_step, 0):.1f}%"]
    total = sum(by_name.values())
    for name, ms in by_name.most_common(12):
        lines.append(f"  {name}: {ms / steps:.4f} ms a step "
                     f"({100 * ms / total:.1f}%)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "relmf_profile.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=30))
    for line in lines:
        phase("profile", line)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    phase("device", f"{torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; matmul "
          f"allow_tf32={tf32}, float32 matmul precision {prec!r}")
    if tf32 or prec != "highest":
        raise AssertionError("TF32 is on: the ALS products must run in "
                             "full float32")

    from cymf_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    path = _kernels.build(verbose=True)
    _kernels.lib()
    phase("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    X = bench_matrix()
    phase("data", f"ML-20M-shaped matrix {X.shape}, {X.count_nonzero()} "
          f"interactions in {time.perf_counter() - t0:.1f} s")
    results = check_kernels(X, dev)
    results.update(check_fused_kernels(X, dev))
    wide, ids = check_wide_kernels(X, dev)
    results.update(wide)
    probed, probe_launches = probes(ids, dev)
    results.update(probed)
    del ids
    results["chol_inv_batched"] = check_chol(X, dev)
    relmf = relmf_ml20m_state(X, dev)
    G = glove_matrix()
    results["glove_sample_phase"] = check_glove_kernels(relmf, G, dev)
    ms_step = relmf_ml20m(relmf, dev)
    if "--profile" in sys.argv[1:]:
        profile_relmf(relmf, dev, ms_step)
    del relmf
    quickstart(dev)
    launches = full_width(X, dev)
    launches.update(pipeline_fits(X, dev))
    launches.update(bpr_wide(X, dev))
    wide_quickstart(dev)
    als_quickstart(dev)
    launches.update(wmf_full_width(X, dev))
    relmf_quickstart(dev)
    launches["glove_sample_phase"] = relmf_full(dev)["glove_sample_phase"]
    glove_full(G, dev)
    if "--profile" in sys.argv[1:]:
        profile_wmf(X, dev)
    del X, G

    X100k = ml100k_matrix()
    G5k = glove_matrix(GLOVE_SMALL_V, GLOVE_SMALL_NNZ)
    results.update(check_seq_kernels(seq_launches(X100k, G5k, dev), dev))
    small = check_seq_kernels(seq_launches(
        quickstart_data().train, glove_matrix(GLOVE_TINY_V, GLOVE_TINY_NNZ),
        dev), dev, "small catalog")
    for name, res in small.items():
        if res["placement"] != 1:
            raise AssertionError(f"{name}: the small catalog left the block")
        results[name]["small_catalog"] = res
    pallas_quickstart(dev)
    launches.update(pallas_full(X100k, G5k, dev))
    launches.update(probe_launches)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
