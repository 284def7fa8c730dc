"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device: requires CUDA, prints ``nvidia-smi`` name and power limit, and
   that float32 products run without TF32;
2. build: compiles the CUDA kernels from ``cymf_tpu_torch/csrc`` and the
   native host prep (``csrc/native_prep.cpp``, ``g++``); then prep: the
   native prep at ML-20M shapes (151 steps x 131,072 on the
   ``bench_interactions`` stream) prints the core count and both thread
   counts, times the filter build, ``prep_epoch`` and ``prep_pool_epoch``
   native against numpy, and checks that two native calls and 1 thread
   against all give the same bits, that the native mask and j side equal
   the numpy rejection and sort applied to the native draws, and that the
   native pool rejection equals numpy's.  Every BPR fit below must draw
   its negatives from the native prep (``prep_backend_ == "native"``;
   bpr-pool and the pool quickstart: the numpy draws with the native
   rejection) and prints per epoch ``prep_s`` and ``device_s``, and the
   fit's wall time and end-to-end int/s beside the device int/s;
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
   shapes (B = 131,072, K = 20) beside #1; P3 (``gather_rows``) at eleven
   sites: R = 27,136 and 131,072, width 128, random and sorted ids, the
   wide step's gathers (W (138,752 x 256) by its sorted users, H (27,136
   x 256) by its items) and the five gathers of the v4 step 0 (``Hp`` by
   ``i`` and ``j``, ``Wp`` by the clamped ``phys_u``, ``Q`` by the
   permutations ``si`` and ``sj``), each the same bits as plain and timed
   beside ``index_select`` by call, in a loop and by device time, with its
   bound (ids and distinct rows read once, the rows written);
4. relmf-ml20m: 1,000 steps of the device-prep RelMF epoch at ML-20M
   shapes (a depth cut of the 28,259-step epoch); ms a step, cells/s,
   peak device memory against its reckoned bound;
5. quickstart: BPR on a small synthetic dataset with validation and
   early stopping must beat an untrained model's test DCG@5 by 0.1,
   through pipeline v5, each of its kernels once a step;
6. full width: 3 epochs of BPR at ML-20M shapes through the public
   ``fit``; the sparse streams must keep pipeline v4, every BPR kernel
   run once per step; then bpr-xla, the portable batch engine
   (``BPR(packed="off")``) at the same shapes: 3 dense Adam epochs, the
   epochs after the first printed beside ``full``'s v4 epochs, and 1
   sparse epoch;
6a. bpr-device-prep: the ``full`` model (3 epochs) under
   ``CYMF_TPU_BPR_PREP=device``: prep ``device-torch``, pipeline v4, each
   of #1-#3 once a step (3 x 151 launches); each epoch's device seconds
   and wall beside ``full``'s native host-prep epochs of this run, the
   fit's end-to-end int/s; step 0's three kernels against plain on its
   device-drawn negatives, and the step's device prep timed (by call, in a
   loop, by device time); at the quickstart's size two fits with one seed
   equal to the bit, test DCG@5 at least 0.8x host prep's, and a resumed
   fit equal to the uninterrupted one;
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
12a. the batch engines at their JAX bench modes' shapes, each fit through
    the public ``fit`` with every launch count 0 (the engines are
    PyTorch ops and run none of the port's kernels), the engine it took
    asserted, the card's name and power limit and the device rate of each
    epoch printed: relmf-xla, ``RelMF(packed="off")`` at ml-1m shapes
    (171 steps of 131,072 cells, 3 epochs), then a non-binary ``X`` and
    ``num_components=128`` at the quickstart's size (the batch engine
    under ``"auto"``); glove-xla, ``GloVe(packed="off")`` d=50 on the
    ``glove_packed`` stream (3 epochs, constant columns exactly one) and
    ``bias_mode="kfold"`` at the same size (1 epoch); batch-quickstart,
    ``BPR`` and ``RelMF`` with ``packed="off"`` on the quickstart data
    must beat an untrained model's test DCG@5 by 0.1, and under
    ``"auto"`` a BPR and a GloVe fit of 4,095 samples must take the batch
    engine and of 4,096 the packed one;
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
    ``bench.py``'s CPU reference (98.46 epochs/s on 8 threads);
16. recommend: ``cymf_tpu_torch.recommend`` at ``bench.py``'s recommend
    shapes (every ML-20M user's top 10 over 26,744 items, d=20, the train
    matrix excluded): device ms a call (CUDA events), the card's busy ms
    (``torch.profiler``), wall ms and users/s by each, over 3 warm calls;
    512 users spread over every chunk must equal a plain per-user
    reference (the full score row, its exclusions, a stable sort by
    score and item id), no excluded item may come back and scores must
    not increase; a tie case (integer factors, users with fewer than k
    finite scores) must give the plain reference's items;
17. checkpoint: fits resumed from their mid-fit checkpoint against
    uninterrupted ones (``rtol 1e-4, atol 1e-4``) on the quickstart's
    data for BPR (packed v4, wide, batch), RelMF (packed with device
    prep, batch), GloVe (packed, batch, kfold; a 256-word stream), WMF and
    ExpoMF; a packed BPR checkpoint resumed on the batch engine; 2 epochs
    of BPR v4 at ML-20M with a checkpoint each epoch beside the same fit
    without: each save's blocking ms, the file's MB and each epoch's
    wall.  Neither phase adds a kernel to the line below;
18. datasets: the file-backed loaders in a temporary ``CYMF_TPU_CACHE``
    on files written from a seed (nothing is downloaded): MovieLens
    ``u.data`` at ml-100k's published size (943 x 1,682, 100,000 ratings)
    and ``ratings.dat`` at ml-1m's (6,040 x 3,706, 1,000,209), each load
    timed, no pandas or sklearn imported; BPR on the loaded ml-100k with
    validation and early stopping must beat an untrained model's test
    DCG@5 by 0.05; ``read_text`` on a 2M-token corpus (Zipf over 50,000
    words), timed, then 3 epochs of GloVe d=50 on its matrix on the card
    and ``save_word2vec_format``;
19. mesh: the sharded paths of ``cymf_tpu_torch.parallel``, each rank
    a process of this script (``--mesh-rank``; the kernels are built
    above, once, before the ranks start), every group joined within
    ``MESH_TIMEOUT_S``, a rank that fails or hangs failing the phase.
    First the single-device results the ranks are held to: ``BPR.fit`` at
    ML-20M (d=20, batch 131,072, Adam, 2 epochs; d=256, 1 epoch), the
    evaluator on all-tie scores (``H = 0``: the metrics do not depend on
    which negatives a rank draws) and ``recommend``'s top 10 (train
    excluded).  Then one rank a card over NCCL (``torch.cuda.device_count()``
    ranks): ``sharded_packed_bpr_epoch`` (one epoch, d=20),
    ``sharded_wide_bpr_epoch`` (d=256, a third of the epoch's steps) and
    ``sharded_bpr_epoch`` (a third) on this rank's ``prep_shard_*``
    streams, each against the single-device epoch on the same draws (this
    rank's W rows and the whole H within ``mesh_close``: ``rtol 2e-3, atol
    2e-5`` for at least 99% of the elements and every element within 3
    lr; the loss within ``rtol 1e-5``), then the evaluator (``rtol 1e-6``) and
    ``recommend`` (the same items) under the mesh.  Then two ranks on card
    0 over gloo: which collectives gloo takes on CUDA tensors (a check
    whose collective it refuses is named and left to the CPU tests), the
    two public fits against the single-device ones (this rank's W rows
    and H), 20 steps of the batch epoch's row exchange, the evaluator and
    ``recommend``.  Each rank prints, beside the card's name and power
    limit, its backend and world size, the first collective's time (the
    communicator's set-up), each epoch's wall and device seconds, the
    bytes all-reduced a step and an all-reduce's ms a step by CUDA events
    (and by the host clock), and its launches.  The other trainers' sharded
    paths follow in each group.  The NCCL ranks call each sharded function
    at full width on the inputs of the public one-device fit's first
    epoch (its calls recorded, or its init and chunks rebuilt) and hold
    the gathered tables to that epoch's: WMF d=256 at ML-20M
    (``sharded_gramian``, ``sharded_wmf_chunk``; chunk 2048, the auto
    Woodbury cap; ``ALS_TOL``), ExpoMF d=128 at ml-1m shapes
    (``sharded_expomf_chunk``, mu row-sharded; ``ALS_TOL``, mu atol 2e-6),
    RelMF at ``relmf-xla``'s shapes (``sharded_relmf_epoch``, the same
    ``torch.Generator`` cells; ``mesh_close``), GloVe fused and kfold at
    ``glove-xla``'s (``sharded_glove_epoch``, ``sharded_glove_kfold_epoch``)
    and packed GloVe at ``glove-full``'s (``prep_glove_shard_static``,
    ``sharded_packed_glove_epoch``; step 0's #8 and both #2 calls against
    their plain forms first), the GloVe tables within rtol 2e-3, atol
    2e-5 and every loss within rtol 1e-5; each prints its wall, device
    time, peak device memory, one step's collectives by CUDA events and
    its launches (#9 for WMF and ExpoMF, #8 and #2 for packed GloVe).
    The gloo ranks fit WMF, ExpoMF, RelMF and GloVe (fused, kfold,
    packed) through the public API at the quickstart's size against the
    same fits in a world of one, each fit's sharded function counted and
    its single-device form not called, then run
    ``parallel/dryrun.py::dryrun_multichip``.  The ranks' launches are
    summed, and each of #1-#3, #2w, #3w, #8 and #9 must show some.

Then it prints the kernels' JSON line (all seventeen), with each kernel's
launches on its main path (a probe's: those of the probes phase),
``phase_launches`` its launches in ``bpr-device-prep``, ``datasets`` and
``mesh`` (summed over the ranks), the
accumulations' loop times (``loop_ms``, and ``library_loop_ms`` for the
single stream's library calls), the dual's device time (``device_ms``),
its bound (the larger of bytes over 3.35 TB/s and float32 operations over
67 TFLOP/s, counted on this run's inputs) and the time of the library call
that computes the same function: ``index_add_`` for ``sorted_accum``,
``index_add_`` and ``bincount`` for ``sorted_accum_wide``,
``index_select`` for ``gather_rows`` (which also carries ``loop_ms``,
``device_ms`` and the library's ``library_loop_ms`` and
``library_device_ms``), and for ``chol_inv_batched`` the two
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
steps at ML-20M shapes and 20 dense Adam steps of the BPR batch engine
at ML-20M shapes, each with the card's idle share, written to
``chiprun_out/relmf_profile.txt`` and ``bpr_batch_profile.txt``.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
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
# each full-width BPR fit's epoch_times_ and epoch walls, by phase name
FIT_EPOCHS: dict = {}
# the batch engines' quickstart: each side of the 4096-sample routing rule
ROUTE_N = 4096
# the H100 SXM's published peaks: HBM3 bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# the bf16 phase: a bfloat16 WMF table's largest relative Frobenius
# distance from the float32 fit's of the same run, and its test DCG@5's
# largest distance on the train matrix
BF16_REL, BF16_DCG = 0.1, 0.02
# profiles taken before a device time falls back to CUDA events, and the
# name that time has in a split (device_split, device_busy)
PROFILE_TRIES, EVENTS_KEY = 3, "(CUDA events: no device time profiled)"
# the checkpoint phase's files, removed after it
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# the mesh phase: its ranks' files (removed after it), a group's join
# limit, the fits' seed, and the kernels its sharded paths must launch
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_TIMEOUT_S, MESH_SEED, MESH_GLOO_BATCH_STEPS = 300, 7, 20
MESH_KERNELS = (*BPR_KERNELS, *WIDE_KERNELS, "glove_sample_phase",
                "chol_inv_batched")


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


def device_split(fn, reps: int = 20, counts: dict | None = None) -> dict:
    """Device time of ``fn()`` a call by CUDA kernel (memsets included),
    ``{name: ms}``, from ``torch.profiler`` over ``reps`` back-to-back
    calls after a warm-up.  Only the device's own events count: the
    profiler also gives a PyTorch operator (``aten::index_select``) the
    time of the kernels it launched, which would count them twice.  With
    ``counts``, each kernel's launches a call go there too.

    A profile can come back without device events (CUPTI's tracing does
    not always attach); after :data:`PROFILE_TRIES` such profiles the
    split is ``{EVENTS_KEY: ms}``, :func:`loop_ms`'s time of ``fn()``
    between CUDA events, and ``counts`` stays as it was."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with _profile() as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split, calls = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            if t > 0:
                split[ev.key[:60]] = t / 1e3 / reps
                calls[ev.key[:60]] = ev.count / reps
        if split:
            if counts is not None:
                counts.update(calls)
            return split
    ms = loop_ms(fn, reps)
    phase("timing", f"torch.profiler saw no device time in {PROFILE_TRIES} "
          f"profiles; CUDA events instead: {ms:.4f} ms a call in a loop")
    return {EVENTS_KEY: ms}


def _profile():
    """A ``torch.profiler`` profile of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


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
            gathers = v4_gathers(t, Q, rw)
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
    return results, gathers


def v4_gathers(t, Q, rw):
    """The five row gathers of a v4 step (``ops/packed_epoch.py``) on
    :func:`first_step`'s tensors and the step's ``Q``, ``[(what, table,
    int32 ids)]``: ``Hp`` by ``i`` and by ``j``, ``Wp`` by the clamped
    ``phys_u``, ``Q`` by the permutations ``si`` and ``sj``."""
    return [(what, T, ix.to(torch.int32)) for what, T, ix in (
        ("v4 step 0: Hp by i", t["Hp"], t["i"]),
        ("v4 step 0: Hp by j", t["Hp"], t["j"]),
        ("v4 step 0: Wp by clamped phys_u", t["Wp"],
         t["phys"].clamp(max=rw - 1)),
        ("v4 step 0: Q by si (a permutation)", Q, t["si"]),
        ("v4 step 0: Q by sj (a permutation)", Q, t["sj"]))]


def gather_sites(ids, v4, dev):
    """P3's sites, ``[(what, table, int32 ids)]``: the script's shape and a
    narrower table (R = 131,072 and 27,136, width 128, B = 131,072 random
    ids and the same sorted), the wide step's gathers (``ids``: its user
    and item ids and its W and H at width 256; W by the clamped users, as
    ``wide_sample_phase`` reads it) and the v4 step's five
    (:func:`v4_gathers`)."""
    rng = np.random.default_rng(1)
    sites = []
    for R in (27136, 131072):
        T = torch.from_numpy(rng.normal(size=(R, 128)).astype(
            np.float32)).to(dev)
        idx = rng.integers(0, R, BATCH).astype(np.int32)
        for order, ix in (("random", idx), ("sorted", np.sort(idx))):
            sites.append((f"R={R} w=128 {order} ids", T,
                          torch.from_numpy(ix).to(dev)))
    u, i, W, H = ids
    sites += [("wide step 0: W by its sorted user ids", W,
               u.clamp(max=W.shape[0] - 1).to(torch.int32)),
              ("wide step 0: H by its item ids", H, i.to(torch.int32))]
    return sites + list(v4)


def same_bits(got, want) -> bool:
    """True where two float32 tensors have one shape and the same bits."""
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def gather_bound(T, ix) -> dict:
    """P3's bound: the ids and each distinct row read once, the ``B`` rows
    written once."""
    row = T.shape[1] * 4
    return bound(ix.numel() * 4 + torch.unique(ix).numel() * row
                 + ix.numel() * row, 0)


def gather_against_library(T, ix, what, reps: int = 20) -> dict:
    """P3 at one site: the kernel's bits against ``gather_rows_plain``'s
    (raises on any difference), then the kernel's and ``index_select``'s
    times, each by call (:func:`time_ms`), in a loop (:func:`loop_ms`) and
    by device time a call (:func:`device_split`), the plain form's by call,
    and the bound (:func:`gather_bound`); ``line`` says it all.  Uses only
    what every version of the wrapper has, so that ``accum_timing.py``
    times older checkouts with it."""
    from cymf_tpu_torch.ops import probes as pr

    got = pr.gather_rows(T, ix)
    want = pr.gather_rows_plain(T, ix)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"gather_rows {what}: differs from plain")

    def kernel():
        return pr.gather_rows(T, ix)

    def lib():
        return torch.index_select(T, 0, ix)

    res = dict(max_abs_err=0.0, ms=time_ms(kernel, reps),
               loop_ms=loop_ms(kernel, reps),
               device_ms=sum(device_split(kernel, reps).values()),
               plain_ms=time_ms(lambda: pr.gather_rows_plain(T, ix), reps),
               **gather_bound(T, ix), library_ms=time_ms(lib, reps),
               library_loop_ms=loop_ms(lib, reps),
               library_device_ms=sum(device_split(lib, reps).values()))
    n = ix.numel()
    res["line"] = (
        f"P3 gather_rows {what} (B={n}, table {tuple(T.shape)}, "
        f"{torch.unique(ix).numel()} distinct rows): the same bits as plain; "
        f"kernel {res['ms']:.4f} ms a call, {res['loop_ms']:.4f} in a loop, "
        f"device {res['device_ms']:.4f}; index_select {res['library_ms']:.4f}"
        f" / {res['library_loop_ms']:.4f} / {res['library_device_ms']:.4f}; "
        f"plain {res['plain_ms']:.4f}; bound {res['bound_ms']:.4f} ms, "
        f"{100 * res['bound_ms'] / res['device_ms']:.1f}% of it by device "
        f"time")
    return res


class env_set:
    """The environment variable ``name`` set to ``value`` inside the block,
    restored after."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        os.environ.pop(self.name)
        if self.saved is not None:
            os.environ[self.name] = self.saved


def forced_kernel(value: str) -> env_set:
    """``CYMF_TPU_PACKED_KERNEL=value`` inside the block (the JAX package's
    switch, which the port honours)."""
    return env_set("CYMF_TPU_PACKED_KERNEL", value)


def numpy_prep() -> env_set:
    """``CYMF_TPU_PREP=numpy`` inside the block: the numpy prep stream and
    rejection."""
    return env_set("CYMF_TPU_PREP", "numpy")


def prep_phase(X):
    """prep: the native host prep (``cymf_tpu_torch.native``) at ML-20M
    shapes, 151 steps of 131,072 on the ``bench_interactions`` stream:
    the filter build, ``prep_epoch`` and ``prep_pool_epoch`` (P = 1024)
    native against numpy, each timed once on the host clock; two native
    calls and 1 thread against all give the same bits; the native mask
    and j side equal the numpy rejection and sort applied to the native
    draws, and the native pool rejection equals numpy's."""
    from cymf_tpu_torch import native
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops import packed_epoch as tpe

    nthreads = native.num_threads()
    tt = torch.get_num_threads()
    phase("prep", f"os.cpu_count() {os.cpu_count()}, native OpenMP threads "
          f"{nthreads}, torch intra-op threads {tt}")
    np.random.seed(0)
    u2, i2 = sorted_batches(*shuffled_interactions(X), BATCH)
    coo = X.tocoo()
    keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
    rh = pk.logical_rows(I, multiple=WROWS)
    sec = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        sec[what] = time.perf_counter() - t0
        return out

    kf = timed("filter", lambda: tpe.make_reject_filter(keys, U, I))
    seed = 1234 * 1_000_003

    def native_epoch():
        return tpe.prep_epoch(None, u2, i2, keys, U, I, 20, rh, WROWS,
                              native_seed=seed, key_filter=kf)

    got = timed("prep_epoch native", native_epoch)
    again = native_epoch()
    native.set_num_threads(1)
    one = timed("prep_epoch native, 1 thread", native_epoch)
    native.set_num_threads(0)
    for a, b, c, name in zip(got, again, one, ("j2", "mask", "sj", "rowsj",
                                               "winj")):
        if not (np.array_equal(a, b) and np.array_equal(a, c)):
            raise AssertionError(f"prep: native {name} differs between "
                                 "calls or thread counts")
    j2, mask, sj, rowsj, winj = got
    with numpy_prep():
        timed("prep_epoch numpy", lambda: tpe.prep_epoch(
            np.random.default_rng((1234, 0)), u2, i2, keys, U, I, 20, rh,
            WROWS))
        want = (tpe._reject_mask(u2, j2, keys, U, I),
                *tpe._sorted_side(j2, rh, WROWS, tpe.TILE))
    for a, b, name in zip((mask, sj, rowsj, winj), want,
                          ("mask", "sj", "rowsj", "winj")):
        if not np.array_equal(a, b):
            raise AssertionError(f"prep: native {name} differs from numpy's "
                                 "on the native draws")
    r2 = np.random.default_rng((1234, 1 << 20)).integers(
        0, POOL_P, u2.shape, dtype=np.int32)

    def pool(key_filter=None):
        return tpe.prep_pool_epoch(np.random.default_rng((1234, 0)), u2,
                                   keys, U, I, POOL_P, r2=r2,
                                   key_filter=key_filter)

    pn = timed("prep_pool_epoch native", lambda: pool(kf))
    with numpy_prep():
        pp = timed("prep_pool_epoch numpy", pool)
    for a, b, name in zip(pn, pp, ("pool2", "rjs", "mask", "j2")):
        if not np.array_equal(a, b):
            raise AssertionError(f"prep: native pool {name} differs from "
                                 "numpy's")
    if native.num_threads() != nthreads or torch.get_num_threads() != tt:
        raise AssertionError("prep: a thread count moved")
    torch.set_num_threads(2)
    two = torch.get_num_threads()
    torch.set_num_threads(tt)
    if two != 2:
        raise AssertionError("prep: torch.set_num_threads does not hold "
                             "beside the native library's OpenMP runtime")
    phase("prep", f"{u2.shape[0]} steps x {BATCH}: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())
          + f"; native {sec['prep_epoch numpy'] / sec['prep_epoch native']:.1f}x"
          " numpy; mask live share "
          f"{mask.mean():.6f}; same bits on two calls and at 1 thread; "
          "mask, sj, rowsj, winj equal numpy's on the native draws; pool "
          "rejection equals numpy's")


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


def check_fused(name, fn, plain, args, kw, outs, limits, nbytes_in, ops,
                same_bits=()):
    """Phase 3 for one of #4-#7: kernel against plain on ``args``; each
    output checked as ``limits`` says (``("rows", rtol, atol)``, or
    ``("lanes", groups)`` group by group as :func:`aw_lanes` gives
    them); the outputs at the indices ``same_bits`` must give the same
    bits on a second call."""
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
    again = fn(*args, **kw)
    for i in same_bits:
        if not torch.equal(again[i].view(torch.int32),
                           got[i].view(torch.int32)):
            raise AssertionError(f"{name}: two calls gave other {outs[i]} "
                                 "bits")
    if same_bits:
        parts.append(f"{', '.join(outs[i] for i in same_bits)} the same "
                     "bits on two calls")
    del again
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


def range_step_args(t, K: int, rw: int, rh: int, dev) -> tuple:
    """The v7 range step's (#6) arguments on the step of
    :func:`first_step` (``t``): its window ranges under
    ``CYMF_TPU_PACKED_KERNEL=7`` (the last window's range re-anchored over
    the padding tail)."""
    from cymf_tpu_torch.ops.packed_epoch import prep_static
    with forced_kernel("7"):
        winw7, *_, v = prep_static(t["u2"], t["i2"], K, rw, rh, WROWS, WROWS)
    if v != 7:
        raise AssertionError(f"forcing v7 gave v{v}")
    st, ct = (torch.from_numpy(a).to(dev) for a in winw7[0])
    return (t["phys"], t["Du"], t["Di"], t["Dj"], st, ct)


def ml1m_step_args(X1, dev, wrows: int, K: int = 20):
    """The v5 sample phase's (#4, ``wrows`` 256) or the v6 block step's
    (#5, ``wrows`` 512) arguments and keywords on step 0 of ``BPR.fit``'s
    ml-1m stream (X1, d=20), which the data gate sends to v5 or v6."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.packed_epoch import prep_epoch
    want_v = {256: 5, 512: 6}[wrows]
    s = pk.num_slots(K)
    coo = X1.tocoo()
    keys1 = np.sort(coo.row.astype(np.int64) * ML1M_I + coo.col)
    rng = np.random.default_rng(0)
    W1 = rng.uniform(-0.1, 0.1, (ML1M_U, K)) / K
    H1 = rng.uniform(-0.1, 0.1, (ML1M_I, K)) / K
    u2, i2, rw, rh, prep = ml1m_streams(X1, K, wrows)
    winw, wstart, si, rowsi, wini, cs, cn, v = prep
    if v != want_v:
        raise AssertionError(f"the ml-1m stream at wrows {wrows} takes "
                             f"v{v}, expected v{want_v}")
    j2, mask, *_ = prep_epoch(np.random.default_rng((1234, 0)), u2[:1],
                              i2[:1], keys1, ML1M_U, ML1M_I, K, rh, wrows)
    Wp, Hp, u, i, j, mf, ws = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            pk.pack_array(W1, K, wrows), pk.pack_logical(H1, K, wrows),
            u2[0], i2[0], j2[0], mask[0], wstart[0]))
    phys = u // s
    Di = Hp.index_select(0, i)
    Dj = fs.decorate(Hp.index_select(0, j), u % s, mf.float(), K)
    if v == 5:
        return (Wp, ws, phys, Di, Dj), dict(K=K, wd=0.01)
    cs_d, cn_d = (torch.from_numpy(a[0]).to(dev) for a in (cs, cn))
    return (Wp, phys, Di, Dj, ws, cs_d, cn_d), dict(K=K, wd=0.01, rw=rw,
                                                    wrows=wrows)


def check_fused_kernels(X, dev):
    """Phase 3 for #4-#7 on step 0 of their main paths: v5 and v6 on the
    ml-1m stream at d=20 (``wrows_w`` 256 gives v5, 512 gives v6), v7 and
    v8 (P = 1024) on the ML-20M stream of :func:`first_step`; and the
    windowed accumulations at the JAX default ``wrows = 512`` on that
    step's H side; v7 and v8 also on the ML-20M stream's last step, whose
    padding tail their parts take like any other samples.  Limits: SW and
    Q rtol 1e-5, atol 1e-6, the loss relative 1e-5, Aw and Apool by lane
    group (:func:`aw_lanes`, :func:`apool_lanes`), the accumulations 1e-5
    max|plain|; #5-#7's Aw and Q the same bits on two calls."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import fused_step as fst
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops import sorted_accum as sa
    K, s = 20, pk.num_slots(20)
    rows_lim = ("rows", 1e-5, 1e-6)
    results = {}
    X1 = ml1m_matrix()
    # per sample the slot extraction and placement (2 x 128 x slots) and
    # ~20 elementwise operations a lane; v6 adds the row sums
    args, kw = ml1m_step_args(X1, dev, 256)
    B = args[3].shape[0]
    results["bpr_sample_phase_v5"] = check_fused(
        f"bpr_sample_phase_v5 (ml-1m step 0, B={B})",
        fs.bpr_sample_phase_v5, fs.bpr_sample_phase_v5_plain, args, kw,
        ("SW", "Q", "loss"), (rows_lim, rows_lim, ("rows", 1e-5, 0)),
        nbytes(*args), B * 128 * (2 * s + 20))
    args, kw = ml1m_step_args(X1, dev, 512)
    B = args[2].shape[0]
    results["bpr_block_step_v6"] = check_fused(
        f"bpr_block_step_v6 (ml-1m step 0, B={B}, wrows 512)",
        fst.bpr_block_step_v6, fst.bpr_block_step_v6_plain, args, kw,
        ("Aw", "Q"), (("lanes", aw_lanes(K)), rows_lim), nbytes(*args),
        B * 128 * (2 * s + 21), same_bits=(0, 1))

    for step in (-1, 0):
        t, rw, rh = first_step(X, K, dev, step)
        B = t["Du"].shape[0]
        when = (f"ML-20M step 0, B={B}" if step == 0 else
                f"ML-20M last step, B={B}, "
                f"{int((t['phys'] >= rw).sum())} padding samples")
        args = range_step_args(t, K, rw, rh, dev)
        results["bpr_range_step_v7"] = check_fused(
            f"bpr_range_step_v7 ({when})", fst.bpr_range_step_v7,
            fst.bpr_range_step_v7_plain, args,
            dict(K=K, wd=0.01, rw=rw, wrows=WROWS), ("Aw", "Q"),
            (("lanes", aw_lanes(K)), rows_lim), nbytes(*args),
            B * 128 * (2 * s + 21), same_bits=(0, 1))

        args = pool_step_args(t, K, rw, rh, dev)
        results["bpr_pool_step_v8"] = check_fused(
            f"bpr_pool_step_v8 ({when}, P={POOL_P})",
            fst.bpr_pool_step_v8, fst.bpr_pool_step_v8_plain, args,
            dict(K=K, wd=0.01, rw=rw, wrows=WROWS), ("Aw", "Apool", "Q"),
            (("lanes", aw_lanes(K)), ("lanes", apool_lanes(K)), rows_lim),
            nbytes(*args), B * 128 * (2 * s + 22), same_bits=(0, 2))
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


def probes(ids, v4, dev):
    """The probes P1-P3 (``csrc/probes.cu``) at their scripts' shapes, each
    against its plain form and timed beside what it measures: P1
    (``phase_v4r``) and P2 (``copy_phase``) beside #1 on the same tiles
    (P1's SW and Q within an ulp of #1's kernel, its loss 1e-5 relative; P2
    exact); P3 (``gather_rows``) at the eleven sites of
    :func:`gather_sites` (``v4``: :func:`v4_gathers`), each the same bits
    as plain and timed beside ``index_select`` by call, in a loop and by
    device time (:func:`gather_against_library`), and at the script's
    shape at every ``rows_in_flight``.  The launches counted are the
    checked calls' (the phase's own run: one a site), not the timing
    repetitions'.  Returns ``(results, launches)``."""
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
    gathers = [(what, T, ix, pr.gather_rows(T, ix))
               for what, T, ix in gather_sites(ids, v4, dev)]
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
        if not same_bits(got, pr.gather_rows_plain(T, ix)):
            raise AssertionError(f"gather_rows {what}: the checked call "
                                 "differs from plain")
        res = gather_against_library(T, ix, what)
        phase("probes", res.pop("line"))
        if what.startswith("R=131072 w=128 random"):
            # the script's own pallas_gather shape is the JSON entry's, and
            # its sweep of the rows a warp keeps in flight (the script's q)
            results["gather_rows"] = res
            sweep = []
            for q in pr.ROWS_IN_FLIGHT:
                if not same_bits(pr.gather_rows(T, ix, rows_in_flight=q),
                                 pr.gather_rows_plain(T, ix)):
                    raise AssertionError(f"gather_rows {what}: differs from "
                                         f"plain at rows_in_flight {q}")

                def call():
                    return pr.gather_rows(T, ix, rows_in_flight=q)

                sweep.append(f"{q}: {time_ms(call):.4f} / "
                             f"{loop_ms(call):.4f}")
            phase("probes", f"P3 gather_rows {what}, the same bits at every "
                  f"rows_in_flight, ms a call / in a loop: "
                  f"{', '.join(sweep)}")
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
    the live tables are on the card (it scores nothing), and stamps the
    host clock at each call (``stamps``: each epoch's end)."""

    def __init__(self, model):
        self.model = model
        self.calls = 0
        self.stamps = []

    def evaluate(self, W, H):
        if self.model._state["W"].device.type != "cuda":
            raise AssertionError("W left the card during the fit")
        self.calls += 1
        self.stamps.append(time.perf_counter())
        return {"DCG@5": 0.0}

    def walls(self, t0: float) -> list:
        """Each epoch's wall seconds, from ``t0`` (the fit's start: the
        first epoch's holds the once-per-fit prep) to its probe call."""
        return list(np.diff([t0, *self.stamps]))


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
    pipeline number.  Its negatives must come from the native prep, or
    with ``neg_pool`` from the numpy stream with the native rejection.
    Prints per epoch the host prep and device seconds (each epoch's prep
    runs beside the previous epoch's device work), and the fit's wall
    time and end-to-end int/s (interactions over the wall time) beside
    the device int/s.  With ``reckon`` (bytes), peak device memory must
    stay under it."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops.packed_epoch import prep_backend

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
    walls = probe.walls(t0)
    FIT_EPOCHS[what] = (m.epoch_times_, walls)
    for e, st in enumerate(m.epoch_times_):
        phase(what, f"epoch {e}: host prep {st['prep_s']:.3f} s, device "
              f"{st['device_s']:.3f} s, {N / st['device_s']:.4e} int/s "
              f"device, wall {walls[e]:.3f} s")
    want_prep = "numpy" if kw.get("neg_pool") else "native"
    dev_s = sum(st["device_s"] for st in m.epoch_times_)
    phase(what, f"prep {m.prep_backend_} (rejection "
          f"{prep_backend()}); fit wall {wall:.3f} s for {epochs} epochs: "
          f"{N * epochs / wall:.4e} int/s end to end, "
          f"{N * epochs / dev_s:.4e} int/s device"
          + (f"; epochs after the first {N / np.mean(walls[1:]):.4e} int/s "
             "end to end" if epochs > 1 else ""))
    if m.prep_backend_ != want_prep or prep_backend() != "native":
        raise AssertionError(f"{what}: prep {m.prep_backend_}, rejection "
                             f"{prep_backend()}, expected {want_prep} with "
                             "the native rejection")
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
    # the bf16 phase's reference: this fit's tables, epochs and peak
    return launches, dict(W=m.W, H=m.H, epochs=m.epoch_times_, peak=peak)


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


def batch_epochs(what, m, probe, t0, n, unit):
    """Print a batch-engine fit's epochs (device seconds by CUDA events,
    ``n`` samples over them, each epoch's wall from ``probe``) and return
    the device seconds."""
    walls = probe.walls(t0) if probe is not None else [np.nan] * len(
        m.epoch_times_)
    secs = [st["device_s"] if isinstance(st, dict) else st
            for st in m.epoch_times_]
    for e, sec in enumerate(secs):
        phase(what, f"epoch {e}: device {sec:.4f} s, {n / sec:.4e} {unit} "
              f"device, wall {walls[e]:.4f} s")
    return secs


def check_batch_fit(what, m, launches, engine_ok, X_shape=None):
    """The batch engine ran, launched none of the kernels, and left finite
    tables (of ``X_shape``'s rows) and loss."""
    if not engine_ok:
        raise AssertionError(f"{what}: the fit did not take the batch engine")
    if launches:
        raise AssertionError(f"{what}: the batch engine launched {launches}")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()):
        raise AssertionError(f"{what}: non-finite loss or tables")
    if X_shape is not None and (m.W.shape[0], m.H.shape[0]) != X_shape:
        raise AssertionError(f"{what}: tables of the wrong shape")


def bpr_xla(X, dev, smi):
    """bpr-xla: ``BPR(packed="off")`` through the public ``fit`` at ML-20M
    shapes (d=20, batch 131,072, Adam lr 0.001, wd 0.01): 3 epochs in
    dense mode, the epochs after the first beside ``full``'s v4 epochs of
    this run, then 1 epoch in sparse mode.  The batch engine runs no
    kernel of the port's: every launch count must stay 0."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    N = X.count_nonzero()
    S = -(-N // BATCH)
    for mode, epochs in (("dense", EPOCHS), ("sparse", 1)):
        what = f"bpr-xla {mode}"
        m = ct.BPR(num_components=20, learning_rate=0.001, optimizer="adam",
                   weight_decay=0.01, batch_size=BATCH, update_mode=mode,
                   packed="off", device=dev)
        probe = _DeviceProbe(m)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        m.fit(X, num_epochs=epochs, valid_evaluator=probe, verbose=False)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        secs = batch_epochs(what, m, probe, t0, N, "int/s")
        phase(what, f"{smi}; engine {m.engine_}, update mode "
              f"{m.update_mode_}, S={S}; fit wall {wall:.3f} s for {epochs} "
              f"epochs ({N * epochs / wall:.4e} int/s end to end); last loss "
              f"{m.last_loss:.6f}; launches {launches}")
        check_batch_fit(what, m, launches, m.engine_ == "batch"
                        and m.update_mode_ == mode, X.shape)
        if probe.calls != epochs:
            raise AssertionError(f"{what}: the fit left the card")
        if mode == "dense":
            FIT_EPOCHS["bpr-xla"] = (secs, probe.walls(t0))
            ms_step = 1e3 * float(np.mean(secs[1:])) / S
            v4, v4_walls = FIT_EPOCHS["full"]
            phase(what, "epochs after the first, device s: batch "
                  f"{[round(x, 4) for x in secs[1:]]} against v4 "
                  f"{[round(st['device_s'], 4) for st in v4[1:]]}; wall s: "
                  f"batch {[round(float(x), 4) for x in probe.walls(t0)[1:]]}"
                  f" against v4 {[round(float(x), 4) for x in v4_walls[1:]]}"
                  f"; {ms_step:.3f} ms a step")
    return ms_step


def relmf_xla(dev, smi):
    """relmf-xla: ``RelMF(packed="off")`` at the JAX ``relmf`` bench
    mode's shapes (ml-1m 6040 x 3706, density 0.04, batch 131,072: 171
    steps, 22.4M cells an epoch), 3 epochs; then at the quickstart's size
    the two fits only the batch engine takes under ``"auto"``: a
    non-binary ``X`` and ``num_components=128``."""
    from scipy import sparse

    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.ops import _kernels

    d = SyntheticImplicitDataset(num_user=ML1M_U, num_item=ML1M_I, rank=8,
                                 density=0.04, seed=0)
    m = ct.RelMF(num_components=RELMF_K, batch_size=BATCH, packed="off",
                 device=dev)
    probe = _DeviceProbe(m)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m.fit(d.train, num_epochs=RELMF_EPOCHS, valid_evaluator=probe)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    S = -(-ML1M_U * ML1M_I // BATCH)
    batch_epochs("relmf-xla", m, probe, t0, m._samples_per_epoch, "cells/s")
    phase("relmf-xla", f"{smi}; packed engine {m.packed_engine_}, update "
          f"mode {m.update_mode_}, S={S}; fit wall {wall:.3f} s; last loss "
          f"{m.last_loss:.6f}; launches {launches}")
    check_batch_fit("relmf-xla", m, launches, m.packed_engine_ is False,
                    (ML1M_U, ML1M_I))
    if m._samples_per_epoch != S * BATCH or probe.calls != RELMF_EPOCHS:
        raise AssertionError("relmf-xla: wrong epoch size or left the card")
    q = quickstart_data()
    Xn = sparse.csr_matrix(q.train).astype(np.float64)
    Xn.data[:] = np.random.default_rng(0).integers(1, 5, Xn.nnz)
    for what, K, Xq in (("non-binary X", RELMF_K, Xn),
                        ("num_components=128", 128, q.train)):
        m = ct.RelMF(num_components=K, learning_rate=0.01, batch_size=8192,
                     device=dev)
        _kernels.reset_launches()
        m.fit(Xq, num_epochs=2)
        launches = dict(_kernels.launches)
        phase("relmf-xla", f"{what} under packed='auto': packed engine "
              f"{m.packed_engine_}, last loss {m.last_loss:.6f}, epochs "
              f"{[round(st['device_s'], 4) for st in m.epoch_times_]} s")
        check_batch_fit(f"relmf-xla {what}", m, launches,
                        m.packed_engine_ is False)


def glove_xla(G, dev, smi):
    """glove-xla: ``GloVe(packed="off")`` d=50 on the ``glove_packed``
    stream (50,000 words), fused biases, 3 epochs, the constant-one
    columns exactly one; then ``bias_mode="kfold"`` (which only the batch
    engine runs) at the same size for 1 epoch."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    S = -(-G.nnz // BATCH)
    for what, kw, epochs in (("glove-xla", dict(packed="off"), GLOVE_EPOCHS),
                             ("glove-xla kfold", dict(bias_mode="kfold"), 1)):
        np.random.seed(0)
        m = ct.GloVe(GLOVE_K, batch_size=BATCH, device=dev, **kw)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        m.fit(G, num_epochs=epochs)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        batch_epochs(what, m, None, t0, G.nnz, "triples/s")
        ones = all(bool((c == 1).all()) for c in m.constant_columns_)
        phase(what, f"{smi}; packed engine {m.packed_engine_}, update mode "
              f"{m.update_mode_}, {G.nnz} triples, S={S}; once-per-fit prep "
              f"{m.prep_s_:.3f} s, fit wall {wall:.3f} s; last loss "
              f"{m.last_loss:.6f}; constant columns exactly one: {ones}; "
              f"launches {launches}")
        check_batch_fit(what, m, launches, m.packed_engine_ is False)
        if not ones:
            raise AssertionError(f"{what}: a constant-one column moved")


def route_matrices(n: int):
    """An interaction matrix and a co-occurrence matrix of ``n`` distinct
    cells in 350 x 350, for the routing rule's two sides."""
    from scipy import sparse
    rng = np.random.default_rng(0)
    cells = rng.choice(350 * 350, n, replace=False)
    rows, cols = cells // 350, cells % 350
    X = sparse.csr_matrix((np.ones(n), (rows, cols)), shape=(350, 350))
    C = sparse.csr_matrix((rng.integers(1, 30, n).astype(np.float64),
                           (rows, cols)), shape=(350, 350))
    return X, C


def batch_quickstart(dev, smi):
    """batch-quickstart: ``BPR(packed="off")`` and ``RelMF(packed="off")``
    on the quickstart data must beat an untrained model's test DCG@5 by
    0.1; then under ``packed="auto"`` a BPR and a GloVe fit of
    ``ROUTE_N - 1`` samples take the batch engine and of ``ROUTE_N`` the
    packed one."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    d = quickstart_data()
    valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                            device=dev)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    fits = (("BPR", ct.BPR, dict(learning_rate=0.01, weight_decay=0.01),
             dict(num_epochs=30, valid_evaluator=valid, early_stopping=True,
                  verbose=False)),
            ("RelMF", ct.RelMF, dict(learning_rate=0.01, weight_decay=1e-4,
                                     batch_size=8192),
             dict(num_epochs=20)))
    for name, cls, kw, fit_kw in fits:
        m0 = cls(num_components=20, packed="off", device=dev, **kw)
        m0.fit(d.train, num_epochs=0)
        base = test.evaluate(m0.W, m0.H)["DCG@5"]
        m = cls(num_components=20, packed="off", device=dev, **kw)
        _kernels.reset_launches()
        m.fit(d.train, **fit_kw)
        launches = dict(_kernels.launches)
        res = test.evaluate(m.W, m.H)
        engine = getattr(m, "engine_", None) or (
            "packed" if m.packed_engine_ else "batch")
        phase("batch-quickstart", f"{name}: test {res}; untrained DCG@5 "
              f"{base:.4f}; {len(m.epoch_times_)} epochs, engine {engine}, "
              f"last loss {m.last_loss:.6f}; launches {launches}")
        check_batch_fit(f"batch-quickstart {name}", m, launches,
                        engine == "batch")
        if not res["DCG@5"] >= base + 0.1:
            raise AssertionError(f"the {name} batch quickstart did not learn")
    for n, want in ((ROUTE_N - 1, "batch"), (ROUTE_N, "packed")):
        X, C = route_matrices(n)
        m = ct.BPR(8, device=dev)
        m.fit(X, num_epochs=1, verbose=False)
        g = ct.GloVe(8, device=dev)
        g.fit(C, num_epochs=1)
        got = (m.engine_, "packed" if g.packed_engine_ else "batch")
        phase("batch-quickstart", f"{smi}; {n} samples under packed='auto': "
              f"BPR {got[0]}, GloVe {got[1]} (want {want})")
        if got != (want, want):
            raise AssertionError(f"routing at {n} samples: {got}")


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

    m = ct.WMF(num_components=ALS_K, device=dev)
    m.fit(X, num_epochs=1, verbose=False)          # warm-up
    with _profile() as prof:
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
        if "chol_regs_kernel" in name:      # csrc/chol_inv.cu
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


def device_busy(run, fallback: bool = False):
    """``(busy_ms, spans, prof)``: the card's busy time during ``run()``,
    its kernel and copy intervals from ``torch.profiler`` merged where
    they overlap, the intervals ``(start_us, end_us, name)`` and the
    profile.  After :data:`PROFILE_TRIES` profiles without device events
    it raises, or with ``fallback`` times ``run()`` between CUDA events:
    one span named :data:`EVENTS_KEY` and no profile."""
    from torch.autograd import DeviceType

    for _ in range(PROFILE_TRIES):
        with _profile() as prof:
            run()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        if spans:
            break
    else:
        if not fallback:
            raise AssertionError("the profile holds no device time")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        phase("timing", f"torch.profiler saw no device time in "
              f"{PROFILE_TRIES} profiles; CUDA events instead: {ms:.4f} ms")
        return ms, [(0.0, 1e3 * ms, EVENTS_KEY)], None
    busy, last = 0.0, -np.inf
    for t0, t1, _ in spans:
        busy += max(t1 - max(t0, last), 0)
        last = max(last, t1)
    return busy / 1e3, spans, prof


def profile_steps(run, steps: int, title: str, ms_step: float,
                  fname: str) -> None:
    """``--profile``: device time by kernel of ``run()`` (``steps``
    steps, after a warm-up call), and the card's busy share of a step
    against the unprofiled ``ms_step``; written to ``chiprun_out/fname``."""
    run()                                          # warm-up
    busy, spans, prof = device_busy(run)
    by_name = collections.Counter()
    for t0, t1, name in spans:
        by_name[name[:70]] += (t1 - t0) / 1e3
    busy_step = busy / steps
    lines = [f"{title}, {torch.cuda.get_device_name(0)}: card busy "
             f"{busy_step:.3f} ms a step (kernel and copy intervals merged) "
             f"against {ms_step:.3f} ms a step unprofiled: idle share "
             f"{100 * max(1 - busy_step / ms_step, 0):.1f}%; "
             f"{len(spans) / steps:.0f} device events a step"]
    total = sum(by_name.values())
    for name, ms in by_name.most_common(12):
        lines.append(f"  {name}: {ms / steps:.4f} ms a step "
                     f"({100 * ms / total:.1f}%)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / fname).write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=30))
    for line in lines:
        phase("profile", line)


def profile_relmf(st, dev, ms_step: float, steps: int = 50):
    """``--profile``: ``steps`` device-prep RelMF steps at ML-20M shapes
    against the unprofiled ``ms_step`` of phase 4."""
    from cymf_tpu_torch.ops import relmf_epoch as tre

    def run():
        tre.packed_relmf_epoch_device(
            st["Wp"], st["Hp"], st["ow"], st["oh"], st["hs"],
            tre.epoch_generator(7, 0, dev), steps, 1.0, **st["kw"])
        torch.cuda.synchronize(dev)

    profile_steps(run, steps, f"{steps} device-prep RelMF steps at ML-20M "
                  "shapes", ms_step, "relmf_profile.txt")


def profile_batch_bpr(X, dev, ms_step: float, steps: int = 20):
    """``--profile``: the first ``steps`` steps of the BPR batch engine's
    dense Adam epoch at ML-20M shapes (d=20, batch 131,072) against the
    unprofiled ``ms_step`` of the bpr-xla phase."""
    from cymf_tpu_torch.models import bpr as mb
    from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
    from cymf_tpu_torch.optim import make_optimizer

    u2, i2 = mb.sorted_batches(*mb.shuffled_interactions(X), BATCH,
                               multiple=1)
    coo = X.tocoo()
    hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.uniform(-0.005, 0.005, (U, 20)), dtype=torch.float32,
                     device=dev)
    H = torch.tensor(rng.uniform(-0.005, 0.005, (I, 20)), dtype=torch.float32,
                     device=dev)
    opt = make_optimizer("adam", 0.001)
    ow, oh = opt.init(W), opt.init(H)
    u_d = torch.from_numpy(u2[:steps]).to(dev)
    i_d = torch.from_numpy(i2[:steps]).to(dev)

    def run():
        mb._bpr_epoch(W, H, ow, oh, u_d, i_d, hs, steps * BATCH,
                      mb.epoch_generator(0, 0, dev), optimizer=opt,
                      weight_decay=0.01, num_users=U, num_items=I,
                      update_mode="dense")
        torch.cuda.synchronize(dev)

    profile_steps(run, steps, f"{steps} dense Adam steps of the BPR batch "
                  "engine at ML-20M shapes", ms_step, "bpr_batch_profile.txt")


def _plain_topk(rows, k):
    """The plain reference of ``recommend`` for each row of ``rows`` (the
    full score row with its exclusions at ``-inf``, numpy): a stable
    sort by (score descending, item id ascending), its first ``k``."""
    ids = np.arange(rows.shape[1])
    return np.stack([np.lexsort((ids, -r))[:k] for r in rows])


def _excluded(X, users, I):
    """``X``'s rows ``users`` as a dense boolean ``(len(users), I)``."""
    return X[users].toarray().astype(bool) if X is not None \
        else np.zeros((len(users), I), bool)


def recommend_phase(X, dev, smi):
    """Phase 16, recommend: ``cymf_tpu_torch.recommend`` at ``bench.py``'s
    recommend shapes (ML-20M: every user's top 10 over 26,744 items, d=20,
    normal factors from ``default_rng(0)``, the train matrix's 20M
    interactions excluded), a warm-up call and 3 timed ones: device ms a
    call between CUDA events, the card's busy ms from ``torch.profiler``
    (kernel and copy intervals merged) and its split by kernel, wall ms,
    and users/s by each.
    512 users spread over every chunk must equal the plain reference on
    the same float32 rows (the chunk's product recomputed), no excluded
    item may come back, and scores must not increase along a row and
    agree with float64 products to rtol 1e-5.  Then a tie case: integer
    factors in [-2, 2] over the same catalog for 4,100 users (two
    chunks), user 0 with I - k + 3 exclusions and user 4,099 with all but
    k - 1 items excluded, its sampled users' items equal to the plain
    reference's on exact float64 scores."""
    import cymf_tpu_torch as ct

    k, chunk = 10, 4096
    rng = np.random.default_rng(0)
    W = rng.normal(size=(U, 20)).astype(np.float32)
    H = rng.normal(size=(I, 20)).astype(np.float32)

    def call():
        return ct.recommend(W, H, k=k, exclude=X, user_chunk=chunk,
                            device=dev)

    call()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        a.record()
        scores, items = call()
        b.record()
        b.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        dev_ms.append(a.elapsed_time(b))
    busy, spans, prof = device_busy(call, fallback=True)
    split = collections.Counter()
    for t0, t1, name in spans:
        split[name[:60]] += (t1 - t0) / 1e3
    d_ms, w_ms = statistics.median(dev_ms), statistics.median(wall_ms)
    floor = bound(2 * U * I * 4 + X.nnz * 8 + U * k * 8, 2 * U * I * 20)
    phase("recommend", f"{smi}; ({U} x {I}, d=20, k={k}, {X.nnz} "
          f"exclusions, chunks of {chunk}): device {d_ms:.2f} ms a call "
          f"between CUDA events, busy {busy:.2f} ms "
          f"({'profiler' if prof is not None else 'CUDA events'}), wall "
          f"{w_ms:.2f} ms (calls {', '.join(f'{t:.2f}' for t in wall_ms)})"
          f"; {U / busy * 1e3:.4e} users/s by busy time, "
          f"{U / d_ms * 1e3:.4e} by events, {U / w_ms * 1e3:.4e} end to "
          f"end; the {'host' if busy < 0.5 * w_ms else 'card'} sets the "
          f"pace; scores written once and read once would take "
          f"{floor['bound_ms']:.2f} ms ({floor['bound_by']})")
    phase("recommend", "device time by kernel: " + "; ".join(
        f"{name} {ms:.2f} ms" for name, ms in split.most_common(6)))

    users = np.unique(np.linspace(0, U - 1, 512).astype(np.int64))
    Wd = torch.from_numpy(W).to(dev)
    Hd = torch.from_numpy(H).to(dev)
    rows = np.empty((len(users), I), np.float32)
    for c in np.unique(users // chunk):
        at = np.nonzero(users // chunk == c)[0]
        full = Wd[c * chunk:(c + 1) * chunk] @ Hd.T    # the call's product
        rows[at] = full[torch.from_numpy(users[at] - c * chunk).to(dev)
                        ].cpu().numpy()
    excl = _excluded(X, users, I)
    rows[excl] = -np.inf
    want = _plain_topk(rows, k)
    got = items[users]
    s64 = np.take_along_axis(W[users].astype(np.float64)
                             @ H.T.astype(np.float64), got, 1)
    if not np.array_equal(got, want):
        bad = int((got != want).any(1).sum())
        raise AssertionError(f"recommend: {bad} of {len(users)} sampled "
                             "users differ from the plain reference")
    if np.take_along_axis(excl, got, 1).any():
        raise AssertionError("recommend returned an excluded item")
    if (np.diff(scores, axis=1) > 0).any() or not np.isfinite(scores).all():
        raise AssertionError("recommend's scores increase along a row")
    close(torch.from_numpy(scores[users]), torch.from_numpy(s64), 1e-5, 1e-5,
          "recommend scores against float64")

    from scipy import sparse
    Ut = 4100
    Wt = rng.integers(-2, 3, (Ut, 20)).astype(np.float32)
    Ht = rng.integers(-2, 3, (I, 20)).astype(np.float32)
    Xt = sparse.lil_matrix(X[:Ut])
    Xt[0, :I - k + 3] = 1
    Xt[Ut - 1, :] = 0
    Xt[Ut - 1, k - 1:] = 1
    Xt = Xt.tocsr()
    t0 = time.perf_counter()
    st, it = ct.recommend(Wt, Ht, k=k, exclude=Xt, device=dev)
    tie_ms = 1e3 * (time.perf_counter() - t0)
    users = np.unique(np.r_[0, Ut - 1, np.linspace(0, Ut - 1, 256)
                            .astype(np.int64)])
    rows = Wt[users].astype(np.float64) @ Ht.T.astype(np.float64)
    rows[_excluded(Xt, users, I)] = -np.inf
    want = _plain_topk(rows, k)
    ties = int(sum((r[w] == r[w[-1]]).sum() > 1 for r, w in zip(rows, want)))
    phase("recommend", f"tie case ({Ut} x {I}, integer factors): "
          f"{len(users)} users checked, {ties} with ties in their top {k}, "
          f"user 0 {int(np.isfinite(rows[0]).sum())} finite scores, user "
          f"{Ut - 1} {int(np.isfinite(rows[-1]).sum())}; {tie_ms:.1f} ms "
          "wall")
    if not np.array_equal(it[users], want):
        raise AssertionError("recommend's tie case differs from the plain "
                             "reference")
    if not np.array_equal(st[users], np.take_along_axis(rows, want, 1)):
        raise AssertionError("recommend's tie-case scores are off")


@contextlib.contextmanager
def param_dtype(dtype):
    """The port's param dtype ``dtype`` inside the block; the one before
    it restored after, whatever happened."""
    from cymf_tpu_torch import config
    prev = config.param_dtype()
    config.set_param_dtype(dtype)
    try:
        yield
    finally:
        config.set_param_dtype(prev)


def _bf16_values(a, what):
    """``a`` is a finite float32 array of bfloat16 values (what a bfloat16
    table comes back as)."""
    a = np.asarray(a)
    if a.dtype != np.float32 or (a.view(np.uint32) & 0xFFFF).any():
        raise AssertionError(f"{what}: not a float32 array of bfloat16 "
                             "values")
    if not np.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")


def bf16_phase(X, dev, smi, wmf32):
    """bf16: the param-dtype switch on the card
    (``config.set_param_dtype(torch.bfloat16)``, float32 restored in a
    ``finally``; no exception is caught and nothing falls back).

    1. WMF d=256 at ML-20M, 2 epochs, beside the float32 ``wmf`` phase of
       this run (``wmf32``): epoch seconds, peak device memory, #9's
       launches (``ALS_EPOCHS * K/64 *`` the standard chunks, as in
       float32); each table within a relative Frobenius distance of
       ``BF16_REL`` of the float32 fit's and the fits' DCG@5 on the train
       matrix within ``BF16_DCG``; then #9 on a bfloat16 copy of the first
       standard chunk's first diagonal block against its plain version
       (both cast to float32 at entry), with ``check_chol``'s limits.
    2. The BPR batch engine (``packed="off"``) at ``bpr-xla``'s shapes, 2
       dense epochs, beside the float32 ``bpr-xla`` epochs of this run.
    3. The evaluator at ML-20M (every user's train positives against 100
       negatives) on those tables, timed under bfloat16 and float32.
    4. ``recommend`` at the recommend phase's shapes, timed; 512 sampled
       users equal to the plain reference on the bfloat16 tables' own
       float32 products, ties counted (bfloat16 makes them common).
    5. The quickstart of BPR and RelMF (batch engines), WMF and ExpoMF
       (d=20): each learns, test DCG@5 at least 0.1 over untrained.
    6. One packed BPR v4 epoch at ML-20M, whose tables must equal the
       float32 epoch's bit for bit (the fused engines ignore the switch).

    Returns the kernels' launches in the bfloat16 runs (1, 2, 5, 6; the
    float32 references and the comparison calls are not counted)."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import chol_kernel as ck

    counts = collections.Counter()

    def counted(run):
        """``run()``'s kernel launches, added to the phase's."""
        _kernels.reset_launches()
        run()
        got = dict(_kernels.launches)
        counts.update(got)
        return got

    ev = ct.AoaEvaluator(X, None, k=5, device=dev)
    with param_dtype(torch.bfloat16):
        # 1. WMF d=256
        m = ct.WMF(num_components=ALS_K, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        n9 = counted(lambda: m.fit(X, num_epochs=ALS_EPOCHS,
                                   verbose=False)).get("chol_inv_batched", 0)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        c = m.chunks_
        want = ALS_EPOCHS * (ALS_K // 64) * (c["W"]["standard"]
                                             + c["H"]["standard"])
        rel = {}
        for name in ("W", "H"):
            got, ref = getattr(m, name), wmf32[name]
            _bf16_values(got, f"bf16 WMF {name}")
            rel[name] = float(np.linalg.norm(got - ref)
                              / np.linalg.norm(ref))
        dcg = ev.evaluate(m.W, m.H)["DCG@5"]
        with param_dtype(torch.float32):
            dcg32 = ev.evaluate(wmf32["W"], wmf32["H"])["DCG@5"]
        phase("bf16", f"{smi}; WMF d={ALS_K} at ML-20M, {ALS_EPOCHS} "
              f"epochs: bf16 {[round(x, 4) for x in m.epoch_times_]} s "
              f"against float32 {[round(x, 4) for x in wmf32['epochs']]} "
              f"s; fit wall {wall:.2f} s; peak device memory "
              f"{peak / 2**30:.3f} GiB against float32's "
              f"{wmf32['peak'] / 2**30:.3f}; chunks W {c['W']} H {c['H']}; "
              f"chol_inv_batched {n9} launches (want {want}); relative "
              f"Frobenius distance from the float32 fit W {rel['W']:.4e}, "
              f"H {rel['H']:.4e} (limit {BF16_REL}); train DCG@5 bf16 "
              f"{dcg:.4f}, float32 {dcg32:.4f}")
        if n9 != want:
            raise AssertionError(f"bf16 WMF: {n9} chol_inv_batched "
                                 f"launches, expected {want}")
        if max(rel.values()) > BF16_REL or abs(dcg - dcg32) > BF16_DCG:
            raise AssertionError("bf16 WMF: too far from the float32 fit")
        # the float32 phase's reckoned bound holds: the bfloat16 tables are
        # half, a chunk's bfloat16 gather and mask with its float32 copy
        # for the products take the bytes of the float32 gather and mask
        gather = min(1 << 25, max((1 << 29) // ALS_K, 1 << 16)) * ALS_K * 4
        reckon = ((U + I) * ALS_K * 4 + 2 * gather
                  + 2 * m.chunk_size * ALS_K ** 2 * 4)
        if peak > reckon:
            raise AssertionError("bf16 WMF: peak device memory above the "
                                 f"reckoned bound {reckon / 2**30:.3f} GiB")

        A, P = first_wmf_block(X, dev)
        blk = A[:, :64, :64].to(torch.bfloat16)
        L, Linv = ck.chol_inv_batched(blk, 64)
        Lp, _ = ck.chol_inv_batched_plain(blk)
        torch.cuda.synchronize()
        err = float((L.double() - Lp.double()).abs().max())
        lim = 1e-4 * float(Lp.abs().max())
        eye = torch.eye(64, dtype=torch.float64, device=dev)
        inv_err = float((Linv.double() @ Lp.double() - eye).abs().max())
        ms = time_ms(lambda: ck.chol_inv_batched(blk, 64))
        pms = time_ms(lambda: ck.chol_inv_batched_plain(blk))
        phase("bf16", f"chol_inv_batched on a bfloat16 {tuple(blk.shape)} "
              f"(first standard user chunk, P={P}), float32 out: max abs dL "
              f"{err:.3e} (limit {lim:.3e}), |Linv L - I| {inv_err:.3e} "
              f"(limit 1e-3); {ms:.4f} ms a call (the cast included) vs "
              f"plain {pms:.4f} ms")
        if not (L.dtype == Linv.dtype == torch.float32) or err > lim \
                or inv_err > 1e-3 or not torch.isfinite(Linv).all():
            raise AssertionError("chol_inv_batched on bfloat16 disagrees")
        del A, blk, L, Linv, Lp

        # 2. the BPR batch engine at bpr-xla's shapes
        N = X.count_nonzero()
        mb = ct.BPR(num_components=20, learning_rate=0.001,
                    optimizer="adam", weight_decay=0.01, batch_size=BATCH,
                    update_mode="dense", packed="off", device=dev)
        probe = _DeviceProbe(mb)
        t0 = time.perf_counter()
        got = counted(lambda: mb.fit(X, num_epochs=2, valid_evaluator=probe,
                                     verbose=False))
        secs = batch_epochs("bf16 bpr-xla", mb, probe, t0, N, "int/s")
        f32 = FIT_EPOCHS["bpr-xla"][0]
        phase("bf16", f"bpr-xla dense epochs, device s: bf16 "
              f"{[round(x, 4) for x in secs]} against float32 "
              f"{[round(x, 4) for x in f32[:2]]}; last loss "
              f"{mb.last_loss:.6f}")
        check_batch_fit("bf16 bpr-xla", mb, got, mb.engine_ == "batch",
                        X.shape)
        _bf16_values(mb.W, "bf16 bpr-xla W")

        # 3. the evaluator at ML-20M
        ev.evaluate(mb.W, mb.H)                          # warm-up
        t0 = time.perf_counter()
        res = ev.evaluate(mb.W, mb.H)
        ev_s = time.perf_counter() - t0
        with param_dtype(torch.float32):
            t0 = time.perf_counter()
            res32 = ev.evaluate(mb.W, mb.H)
            ev32_s = time.perf_counter() - t0
        phase("bf16", f"evaluator at ML-20M ({U} users, their train "
              f"positives and 100 negatives each, d=20): bf16 {ev_s:.3f} s "
              f"{res}; float32 {ev32_s:.3f} s {res32}")
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError("bf16 evaluator: non-finite metrics")

        # 4. recommend at the recommend phase's shapes
        k, chunk = 10, 4096
        rng = np.random.default_rng(0)
        W = rng.normal(size=(U, 20)).astype(np.float32)
        H = rng.normal(size=(I, 20)).astype(np.float32)

        def call():
            return ct.recommend(W, H, k=k, exclude=X, user_chunk=chunk,
                                device=dev)

        call()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            scores, items = call()
            walls.append(1e3 * (time.perf_counter() - t0))
        users = np.unique(np.linspace(0, U - 1, 512).astype(np.int64))
        Wd = torch.from_numpy(W).to(dev, torch.bfloat16)
        Hd = torch.from_numpy(H).to(dev, torch.bfloat16).float()
        rows = np.empty((len(users), I), np.float32)
        for ci in np.unique(users // chunk):
            at = np.nonzero(users // chunk == ci)[0]
            full = Wd[ci * chunk:(ci + 1) * chunk].float() @ Hd.T
            rows[at] = full[torch.from_numpy(users[at] - ci * chunk).to(
                dev)].cpu().numpy()
        rows[_excluded(X, users, I)] = -np.inf
        want = _plain_topk(rows, k)
        ties = int(sum((r[w] == r[w[-1]]).sum() > 1
                       for r, w in zip(rows, want)))
        w_ms = statistics.median(walls)
        phase("bf16", f"recommend ({U} x {I}, d=20, k={k}): wall "
              f"{w_ms:.2f} ms a call ({U / w_ms * 1e3:.4e} users/s); "
              f"{len(users)} sampled users equal to the plain reference on "
              f"the bfloat16 tables, {ties} with ties in their top {k}")
        if not np.array_equal(items[users], want) or scores.dtype \
                != np.float32:
            raise AssertionError("bf16 recommend differs from the plain "
                                 "reference")
        del Wd, Hd, rows

        # 5. the quickstarts
        d = quickstart_data()
        test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
        for name, make, fit in (
                ("BPR", lambda: ct.BPR(20, learning_rate=0.01,
                                       packed="off", device=dev),
                 dict(num_epochs=10, verbose=False)),
                ("RelMF", lambda: ct.RelMF(20, learning_rate=0.01,
                                           weight_decay=1e-4,
                                           batch_size=8192, packed="off",
                                           device=dev),
                 dict(num_epochs=20)),
                ("WMF", lambda: ct.WMF(20, device=dev),
                 dict(num_epochs=10, verbose=False)),
                ("ExpoMF", lambda: ct.ExpoMF(20, device=dev),
                 dict(num_epochs=10, verbose=False))):
            m0 = make()
            m0._ensure_tables(*d.train.shape)
            base = test.evaluate(m0.W, m0.H)["DCG@5"]
            mq = make()
            counted(lambda: mq.fit(d.train, **fit))
            got = test.evaluate(mq.W, mq.H)["DCG@5"]
            phase("bf16", f"{name} quickstart: test DCG@5 {got:.4f}, "
                  f"untrained {base:.4f}")
            _bf16_values(mq.W, f"bf16 {name} quickstart W")
            if not got >= base + 0.1:
                raise AssertionError(f"the bf16 {name} quickstart did not "
                                     "learn")

        # 6. one packed BPR v4 epoch at ML-20M, float32 under the switch
        tables = {}
        with forced_kernel("4"):
            for dt in (torch.float32, torch.bfloat16):
                with param_dtype(dt):
                    mv = ct.BPR(num_components=20, learning_rate=0.001,
                                optimizer="adam", weight_decay=0.01,
                                batch_size=BATCH, device=dev)
                    def fit(mv=mv):
                        mv.fit(X, num_epochs=1, verbose=False)

                    if dt is torch.bfloat16:
                        counted(fit)
                    else:   # the float32 reference's are not the phase's
                        fit()
                    tables[dt] = (mv.W, mv.H, mv.packed_kernel_)
        same = all(np.array_equal(a, b) and a.dtype == np.float32
                   for a, b in zip(*(tables[t][:2] for t in tables)))
        phase("bf16", f"packed BPR v{tables[torch.bfloat16][2]} epoch at "
              f"ML-20M under bfloat16: float32 tables, equal to the float32 "
              f"epoch's bit for bit: {same}")
        if not same or tables[torch.bfloat16][2] != 4:
            raise AssertionError("the packed v4 epoch changed under bf16")
    phase("bf16", f"launches in the bfloat16 runs {dict(counts)}")
    return dict(counts)


def _resume_pair(name, make, X, dev, epochs=6, **fit):
    """``make()`` fitted ``epochs`` epochs against ``epochs // 2`` with a
    checkpoint and the rest resumed from it; their tables must agree
    within the JAX package's resume tolerance (rtol 1e-4, atol 1e-4).
    Returns the error and the resumed model."""
    path = str(CKPT_DIR / f"{name}.npz")

    def run(n, **ck):
        np.random.seed(99)              # GloVe's init reads this stream
        m = make()
        m.fit(X, num_epochs=n, verbose=False, **fit, **ck)
        return m

    m1 = run(epochs)
    run(epochs // 2, checkpoint_path=path)
    m3 = run(epochs, checkpoint_path=path, resume=True)
    if len(m3.checkpoint_s_) != epochs - epochs // 2:
        raise AssertionError(f"{name}: the resumed fit ran "
                             f"{len(m3.checkpoint_s_)} epochs")
    err = 0.0
    names = ("W_central", "W_context", "bias", "context_bias") \
        if hasattr(m1, "W_central") else ("W", "H")
    for attr in names:
        err = max(err, close(torch.from_numpy(np.asarray(getattr(m3, attr))),
                             torch.from_numpy(np.asarray(getattr(m1, attr))),
                             1e-4, 1e-4, f"{name} {attr} resumed")[0])
    return err, m3


def checkpoint_phase(X, dev, smi):
    """Phase 17, checkpoint: on the quickstart's data (GloVe on a
    256-word stream), a fit of 6 epochs against 3 with a checkpoint and 3
    resumed, tables within rtol 1e-4, atol 1e-4, for BPR (packed v4,
    wide, batch), RelMF (packed with device prep, batch), GloVe (packed,
    batch, kfold), WMF and ExpoMF; a packed BPR checkpoint resumed on the
    batch engine (the tables as saved, then a further epoch); then 2
    epochs of BPR v4 at ML-20M shapes with ``checkpoint_every=1`` beside
    the same fit without checkpoints: each save's blocking ms, the file's
    MB, each epoch's wall and the saved tables against the fit's."""
    import shutil

    import cymf_tpu_torch as ct

    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    d = quickstart_data().train
    G = glove_matrix(GLOVE_TINY_V, GLOVE_TINY_NNZ)
    bpr = dict(num_components=20, learning_rate=0.01, device=dev)
    relmf = dict(num_components=20, learning_rate=0.01, weight_decay=1e-4,
                 device=dev)
    glove = dict(num_components=20, learning_rate=0.05, device=dev)
    # name, model, data, environment, attribute, its expected value
    cases = [
        ("bpr-v4", lambda: ct.BPR(**bpr), d, forced_kernel("4"),
         "packed_kernel_", 4),
        ("bpr-wide", lambda: ct.BPR(**dict(bpr, num_components=128)), d,
         None, "engine_", "wide"),
        ("bpr-batch", lambda: ct.BPR(packed="off", **bpr), d, None,
         "engine_", "batch"),
        ("relmf", lambda: ct.RelMF(**relmf), d, None, "prep_backend_",
         "device-torch"),
        ("relmf-batch", lambda: ct.RelMF(packed="off", **relmf), d, None,
         "packed_engine_", False),
        ("glove", lambda: ct.GloVe(**glove), G, None, "packed_engine_",
         True),
        ("glove-batch", lambda: ct.GloVe(packed="off", **glove), G, None,
         "packed_engine_", False),
        ("glove-kfold", lambda: ct.GloVe(bias_mode="kfold", **glove), G,
         None, "packed_engine_", False),
        ("wmf", lambda: ct.WMF(num_components=20, device=dev), d, None,
         "device", dev),
        ("expomf", lambda: ct.ExpoMF(num_components=20, device=dev), d,
         None, "device", dev),
    ]
    for name, make, data, env, attr, want in cases:
        t0 = time.perf_counter()
        with env or contextlib.nullcontext():
            err, m = _resume_pair(name, make, data, dev)
        if getattr(m, attr) != want:
            raise AssertionError(f"{name}: {attr} {getattr(m, attr)}, "
                                 f"expected {want}")
        saves = ", ".join(f"{1e3 * t:.2f}" for t in m.checkpoint_s_)
        phase("checkpoint", f"{name} ({attr} {want}): resumed 3 of 6 "
              f"epochs, max abs error {err:.3e} against the uninterrupted "
              f"fit (rtol 1e-4, atol 1e-4); saves {saves} ms blocking; "
              f"{time.perf_counter() - t0:.1f} s")

    path = str(CKPT_DIR / "cross.npz")
    with forced_kernel("4"):
        m1 = ct.BPR(**bpr)
        m1.fit(d, num_epochs=2, verbose=False, checkpoint_path=path)
    m2 = ct.BPR(packed="off", **bpr)
    m2.fit(d, num_epochs=2, verbose=False, checkpoint_path=path, resume=True)
    err = max(close(torch.from_numpy(m2.W), torch.from_numpy(m1.W), 1e-5,
                    1e-6, "packed -> batch W")[0],
              close(torch.from_numpy(m2.H), torch.from_numpy(m1.H), 1e-5,
                    1e-6, "packed -> batch H")[0])
    m3 = ct.BPR(packed="off", **bpr)
    m3.fit(d, num_epochs=3, verbose=False, checkpoint_path=path, resume=True)
    if m2.checkpoint_s_ or len(m3.checkpoint_s_) != 1 \
            or m3.engine_ != "batch" or not np.isfinite(m3.W).all() \
            or np.allclose(m3.W, m1.W):
        raise AssertionError("packed -> batch: the further epoch")
    phase("checkpoint", f"packed v4 -> batch: the saved tables within "
          f"{err:.3e}; a further batch epoch trained (last loss "
          f"{m3.last_loss:.6f})")

    walls = {}
    for ck in (False, True):
        m = ct.BPR(num_components=20, learning_rate=0.001, optimizer="adam",
                   weight_decay=0.01, batch_size=BATCH, device=dev)
        probe = _DeviceProbe(m)
        path = str(CKPT_DIR / "ml20m.npz") if ck else None
        t0 = time.perf_counter()
        m.fit(X, num_epochs=2, valid_evaluator=probe, verbose=False,
              checkpoint_path=path)
        walls[ck] = probe.walls(t0)
        if m.packed_kernel_ != 4:
            raise AssertionError("the ML-20M fit left pipeline v4")
    mb = os.path.getsize(path) / 1e6
    with np.load(path) as z:
        saved_w, epoch = z["W"][:U], int(z["__epoch__"])
    if epoch != 1 or not np.array_equal(saved_w, m.W):
        raise AssertionError("the ML-20M checkpoint is not the fit's state")
    saves = ", ".join(f"{1e3 * t:.1f}" for t in m.checkpoint_s_)
    on, off = (", ".join(f"{t:.3f}" for t in walls[ck])
               for ck in (True, False))
    phase("checkpoint", f"{smi}; BPR v4 at ML-20M ({U} x {I}, d=20, Adam, "
          f"batch {BATCH}), 2 epochs: saves {saves} ms blocking, file "
          f"{mb:.1f} MB; epoch walls {on} s with a checkpoint each epoch, "
          f"{off} s without (the first epoch holds the once-per-fit prep)")
    shutil.rmtree(CKPT_DIR)


# ---------------------------------------------------------------------------
# device-prep BPR (CYMF_TPU_BPR_PREP=device)
# ---------------------------------------------------------------------------

def device_prep_step(X, dev):
    """bpr-device-prep's kernel check: step 0 of the device-prep epoch at
    ML-20M shapes (the ``full`` model's streams, d=20), its negatives drawn
    from the fit's generator for seed 1234, epoch 0, masked by the pair
    hash set and sorted on the card; the three kernels' outputs against
    their plain forms on the same inputs, at ``check_kernels``'s
    tolerances (the sample kernel rtol 1e-5, atol 1e-6; the accumulations
    within 1e-5 of their max).  Also times the step's device-side prep
    (draw, mask, sort, windows) by call, in a loop and by device time
    (``torch.profiler``).  Returns the kernels' max abs errors."""
    from cymf_tpu_torch.models.bpr import (shuffled_interactions,
                                           sorted_batches)
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops import sorted_accum as sa
    from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
    from cymf_tpu_torch.ops.packed_epoch import (draw_negatives,
                                                 live_negatives,
                                                 prep_static)
    from cymf_tpu_torch.ops.relmf_epoch import (_sorted_side_device,
                                                epoch_generator)

    K = 20
    u2, i2 = sorted_batches(*shuffled_interactions(X), BATCH)
    u2, i2 = u2[:1], i2[:1]
    rw = pk.packed_rows(U, K, multiple=WROWS)
    rh = pk.logical_rows(I, multiple=WROWS)
    winw, _, si, rowsi, wini, *_ = prep_static(u2, i2, K, rw, rh, WROWS,
                                               WROWS)
    coo = X.tocoo()
    hs = to_device(build_pair_hashset(coo.row, coo.col), dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    u, i = put(u2[0]), put(i2[0])
    rng = np.random.default_rng(0)
    Wp = put(pk.pack_array(rng.uniform(-0.1, 0.1, (U, K)) / K, K, WROWS)
             .astype(np.float32))
    Hp = put(pk.pack_logical(rng.uniform(-0.1, 0.1, (I, K)) / K, K, WROWS)
             .astype(np.float32))

    def prep():
        j = draw_negatives(epoch_generator(1234, 0, dev), BATCH, I)
        mf = live_negatives(hs, u, j, U).to(torch.float32)
        return (j, mf, *_sorted_side_device(j, rh, WROWS))

    j, mf, sj, rowsj, wjs, wjc = prep()
    prep_ms, prep_loop = time_ms(prep), loop_ms(prep)
    counts = {}
    split = device_split(prep, counts=counts)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:4]
    s = pk.num_slots(K)
    phys = u // s
    Du = fs.decorate(Wp.index_select(0, phys.clamp(max=rw - 1)), u % s, mf,
                     K)
    args = (Du, Hp.index_select(0, i), Hp.index_select(0, j))
    SW, Q, loss = fs.bpr_sample_phase(*args, K=K, wd=0.01)
    SWp, Qp, lossp = fs.bpr_sample_phase_plain(*args, K=K, wd=0.01)
    torch.cuda.synchronize()
    errs = {"SW": close(SW, SWp, 1e-5, 1e-6, "device prep SW")[0],
            "Q": close(Q, Qp, 1e-5, 1e-6, "device prep Q")[0]}
    close(loss, lossp, 1e-5, 0.0, "device prep loss")
    w_args = (phys, SW, put(winw[0, 0]), put(winw[0, 1]))
    h_args = (put(rowsi[0]), Q.index_select(0, put(si[0])), put(wini[0, 0]),
              put(wini[0, 1]), rowsj, Q.index_select(0, sj), wjs, wjc)
    for name, fn, plain, a, kw in (
            ("sorted_accum", sa.sorted_accum, sa.sorted_accum_plain,
             w_args, dict(r_pad=rw, wrows=WROWS)),
            ("sorted_accum_dual", sa.sorted_accum_dual,
             sa.sorted_accum_dual_plain, h_args,
             dict(r_pad=rh, neg_lanes=K, wrows=WROWS))):
        got, want = fn(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        limit = 1e-5 * float(want.abs().max())
        errs[name] = close(got, want, 0.0, limit, f"device prep {name}")[0]
    live = float(mf.mean())
    phase("bpr-device-prep", f"step 0 at ML-20M (B={BATCH}, d={K}), "
          f"negatives from the fit's generator: {live:.4%} live; "
          "bpr_sample_phase, sorted_accum and sorted_accum_dual against "
          "plain, max abs " + ", ".join(f"{k} {v:.3e}" for k, v in
                                        errs.items())
          + f"; the step's device prep (draw, hash-set mask, sort, "
          f"windows) {prep_ms:.4f} ms a call, {prep_loop:.4f} in a loop, "
          f"device {sum(split.values()):.4f} ms in {sum(counts.values()):g}"
          f" launches of {len(split)} CUDA kernels (the largest: "
          + ", ".join(f"{k} {v:.4f}" for k, v in top) + ")")
    return errs


def bpr_device_prep(X, dev, smi):
    """bpr-device-prep: the ``full`` phase's model (d=20, Adam lr 0.001,
    wd 0.01, batch 131,072, EPOCHS epochs) under
    ``CYMF_TPU_BPR_PREP=device``: pipeline v4, prep ``device-torch``, and
    each of #1-#3 once a step.  Prints each epoch's device seconds and
    wall beside ``full``'s native host-prep epochs of this run, the fit's
    end-to-end int/s; then the kernel check of :func:`device_prep_step`
    and, at the quickstart's size, two fits with one seed equal to the
    bit, test DCG@5 at least 0.8x host prep's, and a resumed fit equal to
    the uninterrupted one.  Returns the kernels' launches."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    m = ct.BPR(num_components=20, learning_rate=0.001, optimizer="adam",
               weight_decay=0.01, batch_size=BATCH, device=dev)
    probe = _DeviceProbe(m)
    N = X.count_nonzero()
    S = -(-N // BATCH)
    with env_set("CYMF_TPU_BPR_PREP", "device"):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        m.fit(X, num_epochs=EPOCHS, valid_evaluator=probe, verbose=False)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
    walls = probe.walls(t0)
    host_times, host_walls = FIT_EPOCHS["full"]
    for e, st in enumerate(m.epoch_times_):
        h = host_times[e]
        phase("bpr-device-prep", f"{smi}; epoch {e}: device "
              f"{st['device_s']:.4f} s ({N / st['device_s']:.4e} int/s), "
              f"wall {walls[e]:.4f} s; full (native host prep) in this "
              f"run: prep {h['prep_s']:.4f} s, device {h['device_s']:.4f} "
              f"s, wall {host_walls[e]:.4f} s")
    dev_s = sum(st["device_s"] for st in m.epoch_times_)
    phase("bpr-device-prep", f"prep {m.prep_backend_}, pipeline "
          f"v{m.packed_kernel_}; fit wall {wall:.3f} s for {EPOCHS} epochs:"
          f" {N * EPOCHS / wall:.4e} int/s end to end, "
          f"{N * EPOCHS / dev_s:.4e} int/s device; epochs after the first "
          f"{N / np.mean(walls[1:]):.4e} int/s end to end (full: "
          f"{N / np.mean(host_walls[1:]):.4e}); last loss "
          f"{m.last_loss:.6f}; launches {launches}")
    want = dict.fromkeys(BPR_KERNELS, EPOCHS * S)
    if m.prep_backend_ != "device-torch" or m.packed_kernel_ != 4 \
            or launches != want:
        raise AssertionError(f"bpr-device-prep: prep {m.prep_backend_}, "
                             f"v{m.packed_kernel_}, launches {launches}, "
                             f"expected device-torch, v4, {want}")
    if probe.calls != EPOCHS or not (np.isfinite(m.last_loss)
                                     and np.isfinite(m.W).all()
                                     and np.isfinite(m.H).all()):
        raise AssertionError("bpr-device-prep: epochs missed or "
                             "non-finite tables")
    device_prep_step(X, dev)
    device_prep_quickstart(dev)
    return launches


def device_prep_quickstart(dev):
    """bpr-device-prep at the quickstart's size (600 x 300, d=20, lr
    0.01, 20 epochs, seed 3): two device-prep fits equal to the bit, test
    DCG@5 at least 0.8x a host-prep fit's, and 3 epochs with a checkpoint
    then 3 resumed equal to 6 uninterrupted."""
    import cymf_tpu_torch as ct

    d = quickstart_data()
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    p = str(CKPT_DIR / "device_prep.npz")

    def fit(prep, epochs=20, **ck):
        m = ct.BPR(num_components=20, learning_rate=0.01, device=dev)
        with env_set("CYMF_TPU_BPR_PREP", prep):
            m.fit(d.train, num_epochs=epochs, verbose=False, seed=3, **ck)
        return m

    host, a, b = fit("host"), fit("device"), fit("device")
    same = np.array_equal(a.W, b.W) and np.array_equal(a.H, b.H)
    dcg_host = test.evaluate(host.W, host.H)["DCG@5"]
    dcg_dev = test.evaluate(a.W, a.H)["DCG@5"]
    full = fit("device", 6)
    fit("device", 3, checkpoint_path=p)
    resumed = fit("device", 6, checkpoint_path=p, resume=True)
    err = max(float(np.abs(resumed.W - full.W).max()),
              float(np.abs(resumed.H - full.H).max()))
    os.remove(p)
    phase("bpr-device-prep", f"quickstart: test DCG@5 {dcg_dev:.4f} "
          f"(device prep, v{a.packed_kernel_}) against {dcg_host:.4f} "
          f"(host prep, v{host.packed_kernel_}); two fits with one seed "
          f"equal to the bit: {same}; resumed against uninterrupted max abs "
          f"{err:.3e}")
    if not same or err != 0.0:
        raise AssertionError("bpr-device-prep: device-prep fits not "
                             "reproducible or resume differs")
    if not dcg_dev >= 0.8 * dcg_host:
        raise AssertionError("bpr-device-prep: device prep under 0.8x "
                             "host prep's test DCG@5")


# ---------------------------------------------------------------------------
# the file-backed datasets
# ---------------------------------------------------------------------------

# ml-100k's and ml-1m's published sizes: users, items, ratings
ML_FILES = {"ml-100k": (943, 1682, 100_000), "ml-1m": (6040, 3706,
                                                       1_000_209)}
TEXT_TOKENS, TEXT_VOCAB = 2_000_000, 50_000
DATA_DIR = ROOT / "build" / "chip_smoke_datasets"


def write_movielens(root: Path, name: str, seed: int = 0) -> None:
    """A file of ``name``'s published size in its format (``u.data``
    tab-separated, ``ratings.dat`` with ``::``): distinct (user, item)
    pairs drawn without replacement in proportion to a power-law user
    activity and item popularity, ratings 1-5 from a planted rank-8 taste
    plus noise, so that a model can learn the kept (>= 4) ratings."""
    n_u, n_i, n = ML_FILES[name]
    rng = np.random.default_rng(seed)
    wu = rng.permutation(np.arange(1, n_u + 1) ** -0.5)
    wi = rng.permutation(np.arange(1, n_i + 1) ** -0.8)
    # Gumbel top-n: n distinct cells drawn in proportion to wu x wi
    keys = np.log(wu)[:, None] + np.log(wi)[None, :]
    keys += rng.gumbel(size=keys.shape)
    cells = np.argpartition(keys.ravel(), -n)[-n:]
    del keys
    uu, ii = cells // n_i, cells % n_i
    fu = rng.normal(size=(n_u, 8)).astype(np.float32)
    fi = rng.normal(size=(n_i, 8)).astype(np.float32)
    z = np.einsum("nk,nk->n", fu[uu], fi[ii]) / np.sqrt(8)
    r = np.clip(np.rint(3.6 + 1.1 * z + 0.5 * rng.normal(size=n)), 1, 5)
    ts = rng.integers(874_724_710, 1_046_454_590, n)
    sep, fname = ("\t", "u.data") if name == "ml-100k" else ("::",
                                                              "ratings.dat")
    d = root / name
    d.mkdir(parents=True)
    (d / fname).write_text("\n".join(
        f"{a}{sep}{b}{sep}{c}{sep}{e}" for a, b, c, e in
        zip((uu + 1).tolist(), (ii + 1).tolist(), r.astype(int).tolist(),
            ts.tolist())) + "\n")


def write_corpus(path: Path, seed: int = 0) -> None:
    """TEXT_TOKENS tokens, Zipf (exponent 1) over TEXT_VOCAB words, in
    lines of 1,000."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1)
    words = np.array([f"w{k}" for k in range(TEXT_VOCAB)])
    toks = words[rng.choice(TEXT_VOCAB, TEXT_TOKENS, p=p / p.sum())]
    path.write_text("\n".join(" ".join(toks[a:a + 1000].tolist())
                              for a in range(0, TEXT_TOKENS, 1000)))


def datasets_phase(dev, smi):
    """datasets: the file-backed loaders in a temporary ``CYMF_TPU_CACHE``
    on files written from a seed (nothing is downloaded): MovieLens
    ml-100k and ml-1m at their published sizes, each load timed, neither
    pandas nor sklearn imported; a BPR fit on the loaded ml-100k with
    validation and early stopping must beat an untrained model's test
    DCG@5 by 0.05; ``read_text`` on a 2M-token corpus, timed, then 3
    epochs of GloVe d=50 on its matrix on the card (#8 and both
    accumulations once a step) and ``save_word2vec_format``.  Returns the
    launches of both fits."""
    import shutil

    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import MovieLens, read_text
    from cymf_tpu_torch.ops import _kernels

    if DATA_DIR.exists():
        shutil.rmtree(DATA_DIR)
    launches = collections.Counter()
    with env_set("CYMF_TPU_CACHE", str(DATA_DIR)):
        loaded = {}
        for name in ML_FILES:
            t0 = time.perf_counter()
            write_movielens(DATA_DIR, name)
            t1 = time.perf_counter()
            loaded[name] = ds = MovieLens(name)
            t2 = time.perf_counter()
            phase("datasets", f"{name}: file written in {t1 - t0:.2f} s, "
                  f"loaded in {t2 - t1:.3f} s: {ds.num_user} x "
                  f"{ds.num_item}, train/valid/test {ds.train_size}/"
                  f"{ds.valid_size}/{ds.test_size}")
            if (ds.num_user, ds.num_item) != ML_FILES[name][:2]:
                raise AssertionError(f"datasets: {name} has "
                                     f"{ds.num_user} x {ds.num_item}")
        stack = sorted({m.split(".")[0] for m in sys.modules}
                       & {"pandas", "sklearn"})
        if stack:
            raise AssertionError(f"datasets: the loaders imported {stack}")

        d = loaded["ml-100k"]
        valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                                device=dev)
        test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
        kw = dict(num_components=20, learning_rate=0.01, device=dev)
        m0 = ct.BPR(**kw)
        m0.fit(d.train, num_epochs=0, verbose=False)
        base = test.evaluate(m0.W, m0.H)["DCG@5"]
        m = ct.BPR(**kw)
        _kernels.reset_launches()
        m.fit(d.train, num_epochs=30, valid_evaluator=valid,
              early_stopping=True, verbose=False)
        launches.update(_kernels.launches)
        res = test.evaluate(m.W, m.H)
        phase("datasets", f"BPR on ml-100k: test {res}; untrained DCG@5 "
              f"{base:.4f}; best valid DCG@5 {m.valid_dcg:.4f}; pipeline "
              f"v{m.packed_kernel_}, prep {m.prep_backend_}; "
              f"{len(m.epoch_times_)} epochs; launches "
              f"{dict(_kernels.launches)}")
        if not res["DCG@5"] >= base + 0.05:
            raise AssertionError("datasets: BPR did not learn ml-100k")

        corpus = DATA_DIR / "corpus.txt"
        t0 = time.perf_counter()
        write_corpus(corpus)
        t1 = time.perf_counter()
        G, i2w = read_text(str(corpus), min_count=5, window_size=10)
        t2 = time.perf_counter()
        phase("datasets", f"read_text: {TEXT_TOKENS} tokens over "
              f"{TEXT_VOCAB} words (written in {t1 - t0:.2f} s) in "
              f"{t2 - t1:.3f} s: vocabulary {len(i2w)}, nnz {G.nnz}")
        np.random.seed(0)
        g = ct.GloVe(GLOVE_K, batch_size=BATCH, device=dev)
        _kernels.reset_launches()
        g.fit(G, num_epochs=GLOVE_EPOCHS)
        glove = dict(_kernels.launches)
        launches.update(glove)
        out = DATA_DIR / "vectors.txt"
        g.save_word2vec_format(str(out), i2w)
        with out.open() as f:
            head = f.readline().split()
            first = f.readline().split()
        S = -(-G.nnz // BATCH)
        phase("datasets", f"{smi}; GloVe d={GLOVE_K} on it: "
              f"{GLOVE_EPOCHS} epochs of S={S}, "
              + ", ".join(f"{t:.4f}" for t in g.epoch_times_)
              + f" s; last loss {g.last_loss:.6f}; launches {glove}; "
              f"word2vec file {out.stat().st_size / 2**20:.1f} MB, header "
              f"{head}")
        if glove != {"glove_sample_phase": GLOVE_EPOCHS * S,
                     "sorted_accum": 2 * GLOVE_EPOCHS * S}:
            raise AssertionError(f"datasets: GloVe launches {glove}")
        if head != [str(len(i2w)), str(GLOVE_K)] or first[0] != i2w[0] \
                or len(first) != GLOVE_K + 1 or not np.isfinite(
                    g.last_loss) or not np.isfinite(g.W).all():
            raise AssertionError("datasets: bad GloVe fit or word2vec file")
    shutil.rmtree(DATA_DIR)
    return dict(launches)


def mesh_close(got, want, lr: float, what: str) -> float:
    """The multi-device tolerance under Adam, the JAX package's 1-against-8
    device one with its first-touch allowance: raises unless both are
    finite, at most 1% of the elements lie outside ``rtol 2e-3, atol
    2e-5`` and every element is within ``3 lr``; returns the max abs
    error."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    off = float((err > 2e-5 + 2e-3 * want.abs()).double().mean())
    worst = float(err.max())
    if off > 0.01 or worst > 3 * lr:
        raise AssertionError(f"{what}: {off:.4%} of the elements outside "
                             f"rtol 2e-3, atol 2e-5; max abs {worst:.3e} "
                             f"against 3 lr = {3 * lr:.3e}")
    return worst


def loss_close(got: float, want: float, what: str) -> None:
    if not (np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)):
        raise AssertionError(f"{what}: loss {got!r} against {want!r} "
                             "(rtol 1e-5)")


def allreduce_ms(mesh, shape, reps: int = 20) -> tuple:
    """One all-reduce of a float32 ``shape`` tensor over the mesh: ms by
    CUDA events (mean of ``reps`` back-to-back calls) and by the host
    clock (the same loop, ending in a synchronize)."""
    t = torch.zeros(shape, dtype=torch.float32, device=mesh.device)
    mesh.all_reduce(t)
    torch.cuda.synchronize(mesh.device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        mesh.all_reduce(t)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, 1e3 * (time.perf_counter() - t0) / reps


def mesh_timed(fn):
    """``fn()``'s result, wall s (host clock to a synchronize) and device
    s (CUDA events around it)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, time.perf_counter() - t0, a.elapsed_time(b) / 1e3


def mesh_init(K: int):
    """The fits' initial tables at width K (the trainers' init)."""
    from cymf_tpu_torch.models.base import uniform_init
    return uniform_init((U, K), K, seed=4321), uniform_init((I, K), K)


def mesh_sorted(X, multiple: int = 1024):
    from cymf_tpu_torch.models.bpr import shuffled_interactions, sorted_batches
    np.random.seed(MESH_SEED)
    users, positives = shuffled_interactions(X)
    return sorted_batches(users, positives, BATCH, multiple=multiple)


def mesh_line(tag, smi, what, wall, dev_s, nbytes, ar, launches):
    phase(tag, f"{smi}; {what}: epoch wall {wall:.4f} s, device "
          f"{dev_s:.4f} s; all-reduced {nbytes / 1e6:.3f} MB a step, "
          f"{ar[0]:.4f} ms a step by CUDA events ({ar[1]:.4f} by the host "
          f"clock); launches {launches}")


def mesh_packed(X, mesh, tag, smi, pos_keys, key_filter) -> dict:
    """NCCL check 1: ``sharded_packed_bpr_epoch`` on this rank's
    ``prep_shard_*`` streams against ``packed_bpr_epoch`` (v4) on the same
    draws, one Adam epoch at ML-20M (d=20, batch 131,072); this rank's W
    rows and the whole H within ``mesh_close``, the loss within rtol 1e-5."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.packed_epoch import (
        make_packed_optimizer, packed_bpr_epoch, prep_epoch,
        prep_shard_epoch, prep_shard_static, prep_static)
    from cymf_tpu_torch.parallel.shard_step import sharded_packed_bpr_epoch

    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    K, lr = 20, 0.001
    u2, i2 = mesh_sorted(X)
    N = X.count_nonzero()
    rw = pk.packed_rows(U, K, multiple=WROWS * n)
    rh = pk.logical_rows(I, multiple=WROWS)
    rw_l = rw // n
    j2, mask, sj, rowsj, winj = prep_epoch(
        np.random.default_rng((MESH_SEED, 0)), u2, i2, pos_keys, U, I, K,
        rh, WROWS, native_seed=MESH_SEED * 1_000_003, key_filter=key_filter)
    winw, wstart, si, rowsi, wini, cs, cn, _ = prep_static(
        u2, i2, K, rw, rh, WROWS, WROWS)
    (u_l, i_l, winw_l, si_l, rowsi_l, wini_l, starts, counts,
     Bd) = prep_shard_static(u2, i2, K, rw, rh, WROWS, WROWS, n, shard=p)
    ep = prep_shard_epoch(j2, mask, starts, counts, Bd, rh, WROWS, n,
                          shard=p)
    W0, H0 = mesh_init(K)
    Wf = pk.pack_array(W0, K, multiple=WROWS * n)
    Hf = pk.pack_logical(H0, K, multiple=WROWS)
    kw = dict(opt_name="adam", lr=lr, weight_decay=0.01, K=K, rw=rw, rh=rh,
              wrows_w=WROWS, wrows_h=WROWS)
    opt = make_packed_optimizer("adam", lr)

    def put(a):  # a copy: the epochs update their tables in place
        return torch.tensor(a, device=dev)

    Wr, Hr = put(Wf), put(Hf)
    owr, ohr = opt.init(Wr), opt.init(Hr)
    loss_ref = float(packed_bpr_epoch(
        Wr, Hr, owr, ohr, *(put(a) for a in (
            u2, i2, si, rowsi, wini, j2, mask, sj, rowsj, winj, winw,
            wstart, cs, cn)), N, kernel_v=4, **kw))
    Wp, Hp = mesh.put_table(Wf), put(Hf)
    ow, oh = opt.init(Wp), opt.init(Hp)
    streams = [put(a[0]) for a in (u_l, i_l, si_l, rowsi_l, wini_l, *ep,
                                   winw_l)]
    _kernels.reset_launches()
    loss, wall, dev_s = mesh_timed(lambda: float(sharded_packed_bpr_epoch(
        mesh, Wp, Hp, ow, oh, *streams, N, **kw)))
    launches = dict(_kernels.launches)
    pay = pk.num_slots(K) * K
    ew = mesh_close(Wp[:, :pay], Wr[p * rw_l:(p + 1) * rw_l, :pay], lr,
                    f"{tag} packed W")
    eh = mesh_close(Hp[:, :K], Hr[:, :K], lr, f"{tag} packed H")
    loss_close(loss, loss_ref, f"{tag} packed")
    mesh_line(tag, smi, f"packed epoch (d={K}, {u2.shape[0]} steps, Bd={Bd}"
              f" of B={BATCH})", wall, dev_s, rh * 128 * 4,
              allreduce_ms(mesh, (rh, 128)), launches)
    phase(tag, f"packed: this rank's W rows max abs err {ew:.3e}, H "
          f"{eh:.3e}, loss {loss:.7f} against {loss_ref:.7f}")
    want = u2.shape[0]
    if any(launches.get(k) != want for k in BPR_KERNELS):
        raise AssertionError(f"{tag} packed: launches {launches}, expected "
                             f"{want} of each v4 kernel")
    return launches


def mesh_wide(X, mesh, tag, smi, pos_keys, key_filter) -> dict:
    """NCCL check 2: ``sharded_wide_bpr_epoch`` against ``wide_bpr_epoch``
    on the same draws at d=256 over the first third of the epoch's
    steps."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops.packed_epoch import (make_packed_optimizer,
                                                 prep_epoch,
                                                 prep_shard_epoch)
    from cymf_tpu_torch.ops.wide_epoch import (
        pack_wide, prep_shard_static_wide, prep_static_wide, wide_bpr_epoch,
        wide_rows, wide_shard_masks, wide_sorted_masks)
    from cymf_tpu_torch.parallel.shard_step import sharded_wide_bpr_epoch

    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    K, lr = WIDE_K, 0.001
    u2, i2 = mesh_sorted(X)
    S3 = u2.shape[0] // 3
    u2, i2 = u2[:S3], i2[:S3]
    N3 = S3 * BATCH
    rw, rh = wide_rows(U, WIDE_WROWS * n), wide_rows(I, WIDE_WROWS)
    rw_l = rw // n
    j2, mask, sj, rowsj, winj = prep_epoch(
        np.random.default_rng((MESH_SEED, 0)), u2, i2, pos_keys, U, I, K,
        rh, WIDE_WROWS, native_seed=MESH_SEED * 1_000_003,
        key_filter=key_filter)
    rowsu, winw, si, rowsi, wini = prep_static_wide(u2, i2, rw, rh,
                                                    WIDE_WROWS)
    mi, mj = wide_sorted_masks(mask, si, sj)
    (u_l, rowsu_l, winw_l, i_l, si_l, rowsi_l, wini_l, starts, counts,
     Bd) = prep_shard_static_wide(u2, i2, rw, rh, WIDE_WROWS, n, shard=p)
    j_l, mf_l, sj_l, rowsj_l, winj_l = prep_shard_epoch(
        j2, mask, starts, counts, Bd, rh, WIDE_WROWS, n, shard=p)
    mi_l, mj_l = wide_shard_masks(mf_l, si_l, sj_l)
    W0, H0 = mesh_init(K)
    Wf = pack_wide(W0, K, multiple=WIDE_WROWS * n)
    Hf = pack_wide(H0, K, multiple=WIDE_WROWS)
    kw = dict(opt_name="adam", lr=lr, weight_decay=0.01, K=K, rw=rw, rh=rh,
              wrows=WIDE_WROWS)
    opt = make_packed_optimizer("adam", lr)

    def put(a):  # a copy: the epochs update their tables in place
        return torch.tensor(a, device=dev)

    Wr, Hr = put(Wf), put(Hf)
    owr, ohr = opt.init(Wr), opt.init(Hr)
    loss_ref = float(wide_bpr_epoch(
        Wr, Hr, owr, ohr, *(put(a) for a in (
            u2, i2, rowsu, winw, si, rowsi, wini, j2, mask, sj, rowsj, winj,
            mi, mj)), N3, **kw))
    Wd, Hd = mesh.put_table(Wf), put(Hf)
    ow, oh = opt.init(Wd), opt.init(Hd)
    streams = [put(a[0]) for a in (u_l, i_l, rowsu_l, winw_l, si_l,
                                   rowsi_l, wini_l, j_l, mf_l, sj_l,
                                   rowsj_l, winj_l, mi_l, mj_l)]
    _kernels.reset_launches()
    loss, wall, dev_s = mesh_timed(lambda: float(sharded_wide_bpr_epoch(
        mesh, Wd, Hd, ow, oh, *streams, N3, **kw)))
    launches = dict(_kernels.launches)
    ew = mesh_close(Wd[:, :K], Wr[p * rw_l:(p + 1) * rw_l, :K], lr,
                    f"{tag} wide W")
    eh = mesh_close(Hd[:, :K], Hr[:, :K], lr, f"{tag} wide H")
    loss_close(loss, loss_ref, f"{tag} wide")
    Kp = Wd.shape[1]
    mesh_line(tag, smi, f"wide epoch (d={K}, {S3} of {3 * S3}+ steps, "
              f"Bd={Bd})", wall, dev_s, rh * (Kp + 128) * 4,
              allreduce_ms(mesh, (rh, Kp + 128)), launches)
    phase(tag, f"wide: this rank's W rows max abs err {ew:.3e}, H {eh:.3e},"
          f" loss {loss:.7f} against {loss_ref:.7f}")
    if any(launches.get(k) != S3 for k in WIDE_KERNELS):
        raise AssertionError(f"{tag} wide: launches {launches}, expected "
                             f"{S3} of each count-lane accumulation")
    return launches


def mesh_batch(X, mesh, tag, smi, steps: int) -> None:
    """``sharded_bpr_epoch`` against the batch engine's ``_bpr_epoch``
    (dense Adam) on the same ``torch.Generator`` stream over the epoch's
    first ``steps`` steps: this rank's rows of W and H within ``mesh_close``,
    the loss within rtol 1e-5."""
    from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
    from cymf_tpu_torch.models.bpr import _bpr_epoch, _draw_negatives
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops.relmf_epoch import epoch_generator
    from cymf_tpu_torch.optim import make_optimizer
    from cymf_tpu_torch.parallel.shard_step import sharded_bpr_epoch

    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    K, lr = 20, 0.001
    u2, i2 = mesh_sorted(X, multiple=n)
    u2, i2 = u2[:steps], i2[:steps]
    steps, B = u2.shape
    Bn = B // n
    N3 = steps * B
    coo = X.tocoo()
    hs = to_device(build_pair_hashset(coo.row, coo.col), dev)
    W0, H0 = mesh_init(K)
    opt = make_optimizer("adam", lr)
    kw = dict(optimizer=opt, weight_decay=0.01, num_users=U, num_items=I)

    def put(a):  # a copy: the epochs update their tables in place
        return torch.tensor(a, device=dev)

    W, H = put(W0.astype(np.float32)), put(H0.astype(np.float32))
    ow, oh = opt.init(W), opt.init(H)
    loss_ref = float(_bpr_epoch(W, H, ow, oh, put(u2), put(i2), hs, N3,
                                epoch_generator(MESH_SEED, 0, dev),
                                update_mode="dense", **kw))
    Wf = np.zeros((mesh.pad_rows(U), K), np.float32)
    Hf = np.zeros((mesh.pad_rows(I), K), np.float32)
    Wf[:U], Hf[:I] = W0, H0
    Ws, Hs = mesh.put_table(Wf), mesh.put_table(Hf)
    ows, ohs = opt.init(Ws), opt.init(Hs)
    u_l, i_l = put(u2[:, p * Bn:(p + 1) * Bn]), put(i2[:, p * Bn:(p + 1) * Bn])
    _kernels.reset_launches()
    loss, wall, dev_s = mesh_timed(lambda: float(sharded_bpr_epoch(
        mesh, Ws, Hs, ows, ohs, u_l, i_l, hs, N3,
        epoch_generator(MESH_SEED, 0, dev), draw=_draw_negatives, **kw)))
    launches = dict(_kernels.launches)
    ru, ri = Ws.shape[0], Hs.shape[0]
    ew = mesh_close(Ws[:max(min(U - p * ru, ru), 0)], W[p * ru:(p + 1) * ru],
                    lr, f"{tag} batch W")
    eh = mesh_close(Hs[:max(min(I - p * ri, ri), 0)], H[p * ri:(p + 1) * ri],
                    lr, f"{tag} batch H")
    loss_close(loss, loss_ref, f"{tag} batch")
    phase(tag, f"{smi}; batch epoch (d={K}, {steps} steps of {Bn} samples a "
          f"rank): wall {wall:.4f} s, device {dev_s:.4f} s; exchanged "
          f"{(3 * B * 4 + 2 * 3 * B * K * 4) / 1e6:.3f} MB a step (indices "
          f"and rows gathered, rows reduce-scattered); this rank's W rows max "
          f"abs err {ew:.3e}, H rows {eh:.3e}, loss {loss:.7f} against "
          f"{loss_ref:.7f}; launches {launches}")
    if launches:
        raise AssertionError(f"{tag} batch: the batch engine launched "
                             f"{launches}")


def mesh_eval_recommend(X, mesh, tag, smi, ref) -> None:
    """The evaluator (all ties: ``H = 0``, so the metrics do not depend on
    the ranks' draws) and ``recommend`` (k = 10, ``X`` excluded) under the
    mesh against the single-device results ``ref`` (``mesh_ref``)."""
    import cymf_tpu_torch as ct
    W, H = mesh_eval_tables()
    ev = ct.Evaluator(X, k=[1, 5], device=mesh.device)
    res, wall, dev_s = mesh_timed(
        lambda: ev.evaluate(W, np.zeros_like(H), seed=MESH_SEED))
    for k, v in res.items():
        want = float(ref[f"eval_{k}"])
        if not abs(v - want) <= 1e-6 * abs(want) + 1e-7:
            raise AssertionError(f"{tag} evaluator {k}: {v!r} against the "
                                 f"single device's {want!r}")
    phase(tag, f"{smi}; evaluator at ML-20M (all ties, {U} users): wall "
          f"{wall:.3f} s, device {dev_s:.3f} s; {res} equal to one device's "
          "within rtol 1e-6")
    (scores, items), wall, dev_s = mesh_timed(
        lambda: ct.recommend(W, H, k=10, exclude=X, device=mesh.device))
    if not np.array_equal(items, ref["rec_items"]):
        raise AssertionError(f"{tag} recommend: items differ from one "
                             "device's")
    err = float(np.abs(scores - ref["rec_scores"]).max())
    if not err <= 1e-5 * float(np.abs(ref["rec_scores"]).max()):
        raise AssertionError(f"{tag} recommend: scores off by {err:.3e}")
    phase(tag, f"{smi}; recommend at ML-20M (k=10, train excluded): wall "
          f"{wall:.3f} s, device {dev_s:.3f} s; items equal to one device's,"
          f" scores within {err:.3e}")


def u2_steps(X) -> int:
    return -(-X.count_nonzero() // BATCH)


def mesh_eval_tables():
    rng = np.random.default_rng(MESH_SEED)
    return (rng.standard_normal((U, 20)).astype(np.float32),
            rng.standard_normal((I, 20)).astype(np.float32))


def mesh_fit(X, dev, K: int, epochs: int, probe: bool = False):
    """The public fit of the mesh phase: d=K, Adam lr 0.001, wd 0.01,
    batch 131,072, the native prep, seed ``MESH_SEED``."""
    import cymf_tpu_torch as ct
    m = ct.BPR(num_components=K, learning_rate=0.001, optimizer="adam",
               weight_decay=0.01, batch_size=BATCH, device=dev)
    pr = _DeviceProbe(m) if probe else None
    t0 = time.perf_counter()
    m.fit(X, num_epochs=epochs, valid_evaluator=pr, verbose=False,
          seed=MESH_SEED)
    return m, pr, t0


def mesh_ref(X, dev, path: Path) -> None:
    """The single-device results the gloo ranks are held to: the packed
    fit (d=20, 2 epochs) and the wide fit (d=256, 1 epoch), the
    evaluator's metrics and ``recommend``'s top 10."""
    import cymf_tpu_torch as ct
    out = {}
    for what, K, epochs in (("packed", 20, 2), ("wide", WIDE_K, 1)):
        m, _, _ = mesh_fit(X, dev, K, epochs)
        out[f"{what}_W"], out[f"{what}_H"] = m.W, m.H
        out[f"{what}_loss"] = np.float64(m.last_loss)
    W, H = mesh_eval_tables()
    ev = ct.Evaluator(X, k=[1, 5], device=dev)
    for k, v in ev.evaluate(W, np.zeros_like(H), seed=MESH_SEED).items():
        out[f"eval_{k}"] = np.float64(v)
    out["rec_scores"], out["rec_items"] = ct.recommend(W, H, k=10,
                                                       exclude=X, device=dev)
    np.savez(path, **out)


def mesh_probe(mesh) -> dict:
    """Which of the collectives the sharded paths make take CUDA tensors
    in this group: ``{name: "ok" or the error}``.  Every rank makes the
    same calls on the same shapes, so a refusal, which gloo raises before
    it communicates, comes on every rank alike."""
    import torch.distributed as dist
    dev, g, n = mesh.device, mesh.group, mesh.num_devices
    calls = {
        "all_reduce": lambda: dist.all_reduce(
            torch.ones(4, device=dev), group=g),
        "all_reduce_max_int64": lambda: dist.all_reduce(
            torch.ones(2, dtype=torch.int64, device=dev),
            op=dist.ReduceOp.MAX, group=g),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(n)],
            torch.ones(4, device=dev), group=g),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(4, device=dev),
            [torch.ones(4, device=dev) for _ in range(n)], group=g),
        "broadcast": lambda: dist.broadcast(
            torch.ones(1, dtype=torch.float64, device=dev), 0, group=g),
        "barrier": lambda: dist.barrier(group=g),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


# the collectives each gloo check makes on CUDA tensors
MESH_NEEDS = {
    "fit": ("all_reduce", "all_reduce_max_int64", "all_gather", "broadcast"),
    "batch": ("all_reduce", "all_gather", "reduce_scatter"),
    "evaluator": ("all_reduce",),
    "recommend": ("all_gather",),
    "models": ("all_reduce", "all_reduce_max_int64", "all_gather",
               "reduce_scatter", "broadcast"),
}


def mesh_gloo(X, mesh, tag, smi, d: Path) -> dict:
    """Two ranks on one card over gloo: the public fits at ML-20M (packed
    d=20, 2 epochs; wide d=256, 1 epoch) against the single-device fits of
    the same seed (``mesh_ref``): this rank's W rows and the whole H
    within ``mesh_close``, the loss within rtol 1e-5; then the batch epoch's
    row exchange (``mesh_batch``), the evaluator and ``recommend``.  A check whose collective gloo refuses on CUDA tensors
    (``mesh_probe``) is named and left to the CPU tests."""
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.wide_epoch import wide_rows

    ref = np.load(d / "ref.npz")
    n, p = mesh.num_devices, mesh.rank
    probe = mesh_probe(mesh)
    phase(tag, f"gloo collectives on CUDA tensors: {probe}")
    refused = {what: [c for c in need if probe[c] != "ok"]
               for what, need in MESH_NEEDS.items()}
    launches = collections.Counter()
    if refused["fit"]:
        phase(tag, f"the packed and wide fits are left to the CPU tests: "
              f"gloo refused {refused['fit']} on CUDA tensors")
    else:
        for what, K, epochs in (("packed", 20, 2), ("wide", WIDE_K, 1)):
            _kernels.reset_launches()
            m, pr, t0 = mesh_fit(X, mesh.device, K, epochs, probe=True)
            launches.update(_kernels.launches)
            if what == "packed":
                rw = pk.packed_rows(U, K, multiple=WROWS * n)
                per = rw // n * pk.num_slots(K)
                rh, width = pk.logical_rows(I, multiple=WROWS), 128
            else:
                rw = wide_rows(U, WIDE_WROWS * n)
                per = rw // n
                rh, width = wide_rows(I, WIDE_WROWS), K + 128
            lo, hi = min(p * per, U), min((p + 1) * per, U)
            ew = mesh_close(torch.from_numpy(m.W[lo:hi]),
                            torch.from_numpy(ref[f"{what}_W"][lo:hi]),
                            0.001, f"{tag} {what} fit W")
            eh = mesh_close(torch.from_numpy(m.H),
                            torch.from_numpy(ref[f"{what}_H"]), 0.001,
                            f"{tag} {what} fit H")
            loss_close(m.last_loss, float(ref[f"{what}_loss"]),
                       f"{tag} {what} fit")
            ar = allreduce_ms(mesh, (rh, width))
            for e, (st, wall) in enumerate(zip(m.epoch_times_,
                                               pr.walls(t0))):
                mesh_line(tag, smi, f"{what} fit (d={K}) epoch {e}: host "
                          f"prep {st['prep_s']:.3f} s", wall,
                          st["device_s"], rh * width * 4, ar,
                          dict(_kernels.launches))
            phase(tag, f"{what} fit: prep {m.prep_backend_}, this rank's "
                  f"W rows [{lo}, {hi}) max abs err {ew:.3e}, H {eh:.3e}, "
                  f"loss {m.last_loss:.7f} against "
                  f"{float(ref[f'{what}_loss']):.7f}")
    if refused["batch"]:
        phase(tag, f"the batch epoch is left to the CPU tests: gloo refused "
              f"{refused['batch']} on CUDA tensors")
    else:
        mesh_batch(X, mesh, tag, smi, steps=MESH_GLOO_BATCH_STEPS)
    if refused["evaluator"] or refused["recommend"]:
        phase(tag, f"the evaluator and recommend are left to the CPU tests: "
              f"gloo refused {refused['evaluator'] + refused['recommend']}")
    else:
        mesh_eval_recommend(X, mesh, tag, smi, ref)
    if refused["models"]:
        phase(tag, f"the other trainers' fits and the dry run are left to the"
              f" CPU tests: gloo refused {refused['models']} on CUDA tensors")
    else:
        launches.update(mesh_gloo_models(mesh, tag, smi))
    return {"launches": dict(launches), "refused": refused}


def mesh_direct(X, mesh, tag, smi, d: Path) -> dict:
    """One rank a card over NCCL: the three sharded BPR epochs called
    directly against their single-device forms, the evaluator and
    ``recommend`` under the mesh against one device's, then the other
    trainers' sharded functions at full width
    (:func:`mesh_models_direct`)."""
    from cymf_tpu_torch.ops.packed_epoch import make_reject_filter

    coo = X.tocoo()
    pos_keys = np.sort(coo.row.astype(np.int64) * I + coo.col)
    key_filter = make_reject_filter(pos_keys, U, I)
    launches = collections.Counter(mesh_packed(X, mesh, tag, smi, pos_keys,
                                               key_filter))
    launches.update(mesh_wide(X, mesh, tag, smi, pos_keys, key_filter))
    mesh_batch(X, mesh, tag, smi, steps=u2_steps(X) // 3)
    mesh_eval_recommend(X, mesh, tag, smi, np.load(d / "ref.npz"))
    launches.update(mesh_models_direct(mesh, tag, smi))
    return {"launches": dict(launches)}


def collectives_ms(mesh, ops, reps: int = 20) -> tuple:
    """One step's collectives ``ops`` (``(method, shape, dtype)`` of
    ``MeshContext``) back to back: ms a step by CUDA events (mean of
    ``reps`` steps) and by the host clock."""
    calls = [(getattr(mesh, op), torch.zeros(shape, dtype=dt,
                                             device=mesh.device))
             for op, shape, dt in ops]
    for fn, t in calls:
        fn(t)
    torch.cuda.synchronize(mesh.device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        for fn, t in calls:
            fn(t)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, 1e3 * (time.perf_counter() - t0) / reps


def mesh_model_line(tag, smi, what, wall, dev_s, peak, coll, unit,
                    launches) -> None:
    phase(tag, f"{smi}; {what}: wall {wall:.4f} s, device {dev_s:.4f} s, "
          f"peak device memory {peak / 2**30:.3f} GiB; collectives "
          f"{coll[0]:.4f} ms {unit} by CUDA events ({coll[1]:.4f} by the "
          f"host clock); launches {launches}")


def warm_epoch(make, fit, dev) -> float:
    """The first epoch's seconds of a second one-device fit (``fit(make())``
    in a world of one), after the kernels and libraries warmed up: the
    epoch the sharded one is timed against."""
    with world_of_one(dev):
        m = make()
        fit(m)
    t = m.epoch_times_[0]
    return t["device_s"] if isinstance(t, dict) else t


def mesh_run(fn, mesh):
    """``fn()`` timed by ``mesh_timed`` from a barrier (every rank starts
    together, so no rank's time holds another's lateness), with the
    launch counts reset before it and the peak device memory measured
    over it: ``(out, wall, device s, peak bytes, launches)``."""
    from cymf_tpu_torch.ops import _kernels
    dev = mesh.device
    mesh.barrier()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    out, wall, dev_s = mesh_timed(fn)
    return (out, wall, dev_s, torch.cuda.max_memory_allocated(dev),
            dict(_kernels.launches))


def world_of_one(dev):
    """A world of one rank on ``dev``: the single-device references run
    under it inside a rank."""
    from cymf_tpu_torch.parallel import MeshContext, use_mesh
    return use_mesh(MeshContext(None, 0, 1, dev))


def mesh_wmf(X, mesh, tag, smi) -> dict:
    """NCCL check 4: one WMF d=256 epoch at ML-20M (chunk 2048, weight 10,
    the auto Woodbury cap) by ``sharded_gramian`` and ``sharded_wmf_chunk``
    on ``place_mesh_chunks``' chunks, from the public fit's init, against
    that fit's first epoch on one device; the gathered tables within
    ``ALS_TOL``.  Launches #9 (``cholesky_cuda64``)."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models.base import as_csr, padded_rows
    from cymf_tpu_torch.models.wmf import woodbury_max_p
    from cymf_tpu_torch.ops import als
    from cymf_tpu_torch.parallel.mesh import fetch_to_host
    from cymf_tpu_torch.parallel.shard_step import (sharded_gramian,
                                                    sharded_wmf_chunk)

    n, dev, K = mesh.num_devices, mesh.device, ALS_K
    X = as_csr(X)
    m = ct.WMF(num_components=K, device=dev)
    m._ensure_tables(U, I)
    W0, H0 = m.W, m.H
    with world_of_one(dev):
        m.fit(X, num_epochs=1, verbose=False)
    solver = als.resolve_chol_solver(m.solver, K, dev)
    cap = woodbury_max_p(K, m.weight, m.weight_decay, solver)
    Up, Ip = mesh.pad_rows(U), mesh.pad_rows(I)
    Xt = X.T.tocsr()
    Xt.sort_indices()
    sides = [als.build_chunks(A, m.chunk_size, rows, num_components=K)
             for A, rows in ((X, Up), (Xt, Ip))]
    big = max((c for cs in sides for c in cs if c.idx_pad.shape[1] > cap),
              key=lambda c: c.idx_pad.size)
    sides = [als.place_mesh_chunks(cs, mesh) for cs in sides]
    W = mesh.put_table(padded_rows(W0, Up))
    H = mesh.put_table(padded_rows(H0, Ip))

    def epoch():
        for T, Y, chunks in ((W, H, sides[0]), (H, W, sides[1])):
            A0 = sharded_gramian(mesh, Y, m.weight_decay)
            A0i = torch.linalg.inv_ex(A0)[0] if any(
                c.idx_pad.shape[1] <= cap for c in chunks) else None
            for ch in chunks:
                sharded_wmf_chunk(mesh, Y, T, A0, A0i, ch, weight=m.weight,
                                  solver=solver, wb_max_p=cap)

    _, wall, dev_s, peak, launches = mesh_run(epoch, mesh)
    ew = close(torch.from_numpy(fetch_to_host(W, mesh)[:U]),
               torch.from_numpy(m.W), *ALS_TOL.values(), f"{tag} WMF W")
    eh = close(torch.from_numpy(fetch_to_host(H, mesh)[:I]),
               torch.from_numpy(m.H), *ALS_TOL.values(), f"{tag} WMF H")
    C, P = big.idx_pad.shape
    C += -C % n
    coll = collectives_ms(mesh, [
        ("all_gather", (C // n * P,), torch.int32),
        ("reduce_scatter", (C * P, K), torch.float32),
        ("all_gather", (C // n, K), torch.float32)])
    nchunks = sum(map(len, sides))
    mesh_model_line(tag, smi, f"WMF epoch (d={K}, {nchunks} chunks, "
                    f"Woodbury at P <= {cap}, solver {solver})", wall, dev_s,
                    peak, coll, f"for the largest standard chunk (C={C}, "
                    f"P={P})", launches)
    warm = warm_epoch(lambda: ct.WMF(num_components=K, device=dev),
                      lambda w: w.fit(X, num_epochs=1, verbose=False), dev)
    phase(tag, f"WMF: one-device epoch {warm:.4f} s (warm; the reference "
          f"fit's {m.epoch_times_[0]:.4f}); gathered "
          f"W max abs err {ew[0]:.3e}, H {eh[0]:.3e} (rtol "
          f"{ALS_TOL['rtol']}, atol {ALS_TOL['atol']})")
    std = sum(c.idx_pad.shape[1] > cap for cs in sides for c in cs)
    if launches.get("chol_inv_batched") != (K // 64) * std:
        raise AssertionError(f"{tag} WMF: launches {launches}, expected "
                             f"{(K // 64) * std} of chol_inv_batched")
    return launches


def mesh_expomf(mesh, tag, smi) -> dict:
    """NCCL check 5: one ExpoMF d=128 epoch at ``bench.py::bench_expomf``'s
    ml-1m shapes (6,040 x 3,706, density 0.04, chunk 512) by
    ``sharded_expomf_chunk`` (both sweeps, mu row-sharded) from the public
    fit's init, against that fit's first epoch on one device; the
    gathered W, H within ``ALS_TOL`` and mu within rtol 2e-3, atol 2e-6.
    Launches #9."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.models.base import as_csr, padded_rows
    from cymf_tpu_torch.ops import als
    from cymf_tpu_torch.parallel.mesh import fetch_to_host
    from cymf_tpu_torch.parallel.shard_step import (rows_everywhere,
                                                    sharded_expomf_chunk)

    n, p, dev, K = mesh.num_devices, mesh.rank, mesh.device, 128
    X = as_csr(SyntheticImplicitDataset(num_user=ML1M_U, num_item=ML1M_I,
                                        rank=8, density=0.04, seed=0).train)
    Ux, Ix = X.shape
    m = ct.ExpoMF(num_components=K, device=dev)
    m._ensure_tables(Ux, Ix)
    W0, H0 = m.W, m.H
    with world_of_one(dev):
        m.fit(X, num_epochs=1, verbose=False)
    solver = als.resolve_chol_solver(m.solver, K, dev)
    Up, Ip = mesh.pad_rows(Ux), mesh.pad_rows(Ix)
    Xt = X.T.tocsr()
    Xt.sort_indices()
    raw = [als.build_chunks(A, m.chunk_size, rows, num_components=K)
           for A, rows in ((X, Up), (Xt, Ip))]
    sides = [als.place_mesh_chunks(cs, mesh) for cs in raw]
    W = mesh.put_table(padded_rows(W0, Up))
    H = mesh.put_table(padded_rows(H0, Ip))
    mu = mesh.put_table(torch.full((Ip,), 0.01))
    rpd = Ip // n
    live = (torch.arange(rpd, device=dev) + p * rpd) < Ix
    kw = dict(lam_y=m.lam_y, prefactor=m.prefactor, solver=solver,
              ridge=(m.weight_decay / m.lam_y) * torch.eye(K, device=dev))

    def epoch():
        W0d, H0d = W.clone(), H.clone()
        term = torch.where(live, (1.0 - mu) / mu, 1.0)
        colsum = torch.zeros(rpd, device=dev)
        for ch in sides[0]:
            colsum += sharded_expomf_chunk(
                mesh, W0d, H0d, H0d, term, W, ch, mu_axis="col",
                num_real_rows=Ux, num_real_cols=Ix, **kw)
        for ch in sides[1]:
            rows = rows_everywhere(mesh, term[:, None], ch.rows)[:, 0]
            sharded_expomf_chunk(mesh, H0d, W0d, W, rows, H, ch,
                                 mu_axis="row", num_real_rows=Ix,
                                 num_real_cols=Ux, **kw)
        # expomf.pyx:113-114,142: a Beta(1, 1) prior
        mu.copy_(torch.where(live, (1.0 + colsum - 1.0) / (2.0 + Ux - 2.0),
                             mu))

    _, wall, dev_s, peak, launches = mesh_run(epoch, mesh)
    ew = close(torch.from_numpy(fetch_to_host(W, mesh)[:Ux]),
               torch.from_numpy(m.W), *ALS_TOL.values(), f"{tag} ExpoMF W")
    eh = close(torch.from_numpy(fetch_to_host(H, mesh)[:Ix]),
               torch.from_numpy(m.H), *ALS_TOL.values(), f"{tag} ExpoMF H")
    em = close(torch.from_numpy(fetch_to_host(mu, mesh)[:Ix]),
               torch.from_numpy(m.mu), 2e-3, 2e-6, f"{tag} ExpoMF mu")
    big = max((c for cs in raw for c in cs), key=lambda c: c.idx_pad.size)
    C, P = big.idx_pad.shape
    C += -C % n
    coll = collectives_ms(mesh, [
        ("all_reduce", (C, K), torch.float32),
        ("all_gather", (C // n, P), torch.int32),
        ("reduce_scatter", (C, K, K), torch.float32),
        ("reduce_scatter", (C * P, K), torch.float32),
        ("all_gather", (C // n, K), torch.float32)])
    nchunks = sum(map(len, sides))
    mesh_model_line(tag, smi, f"ExpoMF epoch (ml-1m {Ux} x {Ix}, d={K}, "
                    f"{nchunks} chunks, solver {solver})", wall, dev_s, peak,
                    coll, f"for the largest chunk (C={C}, P={P})", launches)
    warm = warm_epoch(lambda: ct.ExpoMF(num_components=K, device=dev),
                      lambda e: e.fit(X, num_epochs=1, verbose=False), dev)
    phase(tag, f"ExpoMF: one-device epoch {warm:.4f} s (warm; the reference "
          f"fit's {m.epoch_times_[0]:.4f}); gathered W max abs err "
          f"{ew[0]:.3e}, H {eh[0]:.3e}, mu {em[0]:.3e}")
    if launches.get("chol_inv_batched") != (K // 64) * nchunks:
        raise AssertionError(f"{tag} ExpoMF: launches {launches}, expected "
                             f"{(K // 64) * nchunks} of chol_inv_batched")
    return launches


def mesh_relmf(mesh, tag, smi) -> None:
    """NCCL check 6: ``sharded_relmf_epoch`` at ``relmf-xla``'s shapes
    (ml-1m 6,040 x 3,706, batch 131,072: 171 steps, Adam) on the inputs the
    public one-device batch engine's first epoch took (its ``_relmf_epoch``
    call recorded) and the same ``torch.Generator`` stream; the gathered
    tables within ``mesh_close``, the loss within rtol 1e-5."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.models import relmf
    from cymf_tpu_torch.models.base import padded_rows
    from cymf_tpu_torch.ops.relmf_epoch import epoch_generator
    from cymf_tpu_torch.parallel.mesh import fetch_to_host
    from cymf_tpu_torch.parallel.shard_step import sharded_relmf_epoch

    n, dev = mesh.num_devices, mesh.device
    X = SyntheticImplicitDataset(num_user=ML1M_U, num_item=ML1M_I, rank=8,
                                 density=0.04, seed=0).train
    m = ct.RelMF(num_components=RELMF_K, batch_size=BATCH, packed="off",
                 update_mode="dense", device=dev)
    with world_of_one(dev):
        got = record_calls(relmf, {"_relmf_epoch": 1},
                           lambda: m.fit(X, num_epochs=1, seed=MESH_SEED))
    (W, H, ow, oh, labels, props, _), kw = got["_relmf_epoch"][0]
    B, S = kw["batch_size"], kw["num_steps"]
    K = W.shape[1]
    Ws, Hs = (mesh.put_table(padded_rows(T, mesh.pad_rows(T.shape[0])))
              for T in (W, H))
    opt = kw["optimizer"]
    ows, ohs = opt.init(Ws), opt.init(Hs)
    loss, wall, dev_s, peak, launches = mesh_run(lambda: float(
        sharded_relmf_epoch(
            mesh, Ws, Hs, ows, ohs, labels, props,
            epoch_generator(MESH_SEED, 0, dev), optimizer=opt,
            weight_decay=kw["weight_decay"], clip_value=kw["clip_value"],
            num_users=ML1M_U, num_items=ML1M_I, num_steps=S, batch_size=B,
            binary=kw["binary_labels"], draw=relmf._draw_cells)) / (S * B),
        mesh)
    lr = m.learning_rate
    ew = mesh_close(torch.from_numpy(fetch_to_host(Ws, mesh)[:ML1M_U]),
                    torch.from_numpy(m.W), lr, f"{tag} RelMF W")
    eh = mesh_close(torch.from_numpy(fetch_to_host(Hs, mesh)[:ML1M_I]),
                    torch.from_numpy(m.H), lr, f"{tag} RelMF H")
    loss_close(loss, m.last_loss, f"{tag} RelMF")
    coll = collectives_ms(mesh, [
        ("reduce_scatter", (B, 2 * K), torch.float32),
        ("all_gather", (B // n, 2 * K), torch.float32)])
    mesh_model_line(tag, smi, f"RelMF batch epoch (ml-1m, d={K}, {S} steps "
                    f"of {B} cells)", wall, dev_s, peak, coll, "a step",
                    launches)
    warm = warm_epoch(
        lambda: ct.RelMF(num_components=RELMF_K, batch_size=BATCH,
                         packed="off", update_mode="dense", device=dev),
        lambda r: r.fit(X, num_epochs=1, seed=MESH_SEED), dev)
    phase(tag, f"RelMF: one-device epoch {warm:.4f} s (warm; the reference "
          f"fit's {m.epoch_times_[0]['device_s']:.4f}); gathered W max abs err "
          f"{ew:.3e}, H {eh:.3e}, loss {loss:.7f} against "
          f"{m.last_loss:.7f}")
    if launches:
        raise AssertionError(f"{tag} RelMF: the batch engine launched "
                             f"{launches}")


def mesh_glove_batch(G, mesh, tag, smi) -> None:
    """NCCL check 7: ``sharded_glove_epoch`` (fused biases) and
    ``sharded_glove_kfold_epoch`` at ``glove-xla``'s shapes (d=50, the
    50,000-word stream, batch 131,072) on the inputs the public one-device
    batch engine's first epoch took (its ``_glove_epoch`` call recorded),
    each rank its slice of every step; the gathered tables (biases
    included) within rtol 2e-3, atol 2e-5 of that epoch's, the loss
    within rtol 1e-5."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import glove
    from cymf_tpu_torch.models.base import padded_rows
    from cymf_tpu_torch.ops.glove_epoch import augment_tables
    from cymf_tpu_torch.parallel.mesh import fetch_to_host
    from cymf_tpu_torch.parallel.shard_step import (
        sharded_glove_epoch, sharded_glove_kfold_epoch)

    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    V1, V2 = G.shape
    for mode in ("fused", "kfold"):
        np.random.seed(0)
        m = ct.GloVe(GLOVE_K, batch_size=BATCH, packed="off",
                     update_mode="dense", bias_mode=mode, device=dev)
        with world_of_one(dev):
            got = record_calls(glove, {"_glove_epoch": 1},
                               lambda: m.fit(G, num_epochs=1))
        args, kw = got["_glove_epoch"][0]
        tables, (c2, x2, n2, N) = args[:8], args[8:]
        S, B = c2.shape
        Bn, K = B // n, kw["num_components"]
        sh = [mesh.put_table(padded_rows(T, mesh.pad_rows(T.shape[0])))
              for T in tables[:4]]
        opt = kw["optimizer"]
        states = [opt.init(T) for T in sh[:2]] + \
            [torch.ones_like(T) for T in sh[2:]]
        steps = [a[:, p * Bn:(p + 1) * Bn].contiguous() for a in (c2, x2,
                                                                  n2)]
        common = dict(optimizer=opt, x_max=kw["x_max"], alpha=kw["alpha"],
                      K=K, num_central=V1)
        if mode == "fused":
            def run():
                return float(sharded_glove_epoch(
                    mesh, sh[0], sh[1], *states[:2], *steps, N, **common))
            width = K + 2
            ops = [("reduce_scatter", (B, 2 * width), torch.float32),
                   ("all_gather", (Bn, 2 * width), torch.float32)]
        else:
            def run():
                return float(sharded_glove_kfold_epoch(
                    mesh, *sh, *states, *steps, N,
                    num_central_pad=sh[0].shape[0] * n, **common))
            ops = [("reduce_scatter", (B, 2 * K + 2), torch.float32),
                   ("all_gather", (Bn, 2 * K + 1), torch.float32)]
        loss, wall, dev_s, peak, launches = mesh_run(run, mesh)
        Wc, Wx, bc, bx = (fetch_to_host(T, mesh) for T in sh)
        if mode == "kfold":
            Wc, Wx = augment_tables(Wc[:V1], bc[:V1, 0], Wx[:V2],
                                    bx[:V2, 0])
        want = augment_tables(m.W_central, m.bias, m.W_context,
                              m.context_bias)
        errs = [close(torch.from_numpy(np.asarray(g[:len(w)], np.float64)),
                      torch.from_numpy(w), 2e-3, 2e-5,
                      f"{tag} GloVe {mode} {side}")[0]
                for g, w, side in zip((Wc, Wx), want, ("central",
                                                       "context"))]
        loss_close(loss, m.last_loss, f"{tag} GloVe {mode}")
        coll = collectives_ms(mesh, [("all_gather", (Bn, 2), torch.int32),
                                     *ops])
        mesh_model_line(tag, smi, f"GloVe {mode} batch epoch (d={K}, "
                        f"{V1} words, {S} steps of {B})", wall, dev_s, peak,
                        coll, "a step", launches)
        warm = warm_epoch(
            lambda: ct.GloVe(GLOVE_K, batch_size=BATCH, packed="off",
                             update_mode="dense", bias_mode=mode, device=dev),
            lambda g: g.fit(G, num_epochs=1), dev)
        phase(tag, f"GloVe {mode}: one-device epoch {warm:.4f} s (warm; the "
              f"reference fit's {m.epoch_times_[0]:.4f}); gathered tables max"
              f" abs err {max(errs):.3e}, loss "
              f"{loss:.7f} against {m.last_loss:.7f}")
        if launches:
            raise AssertionError(f"{tag} GloVe {mode}: the batch engine "
                                 f"launched {launches}")


def mesh_glove_packed(G, mesh, tag, smi) -> dict:
    """NCCL check 8: ``sharded_packed_glove_epoch`` at ``glove-full``'s
    shapes (d=50, 50,000 words, 3M triples, batch 131,072: 23 steps) on
    ``prep_glove_shard_static``'s streams of the steps the public
    one-device packed fit prepared (its ``prep_glove_static`` call
    recorded), from that fit's init, against its first epoch: step 0's #8
    and both of its #2 calls held against their plain forms, then the
    epoch timed; the gathered tables within rtol 2e-3, atol 2e-5, the loss
    within rtol 1e-5, the constant columns exactly one."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import glove
    from cymf_tpu_torch.ops import glove_epoch as ge
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.parallel.mesh import fetch_to_host
    from cymf_tpu_torch.parallel.shard_step import sharded_packed_glove_epoch

    n, p, dev = mesh.num_devices, mesh.rank, mesh.device
    np.random.seed(0)
    m = ct.GloVe(GLOVE_K, batch_size=BATCH, packed="on", device=dev)
    with world_of_one(dev):
        got = record_calls(glove, {"prep_glove_static": 1,
                                   "packed_glove_epoch": 1},
                           lambda: m.fit(G, num_epochs=1))
    (c2, x2, n2, V1, K, _, rh, ww, wh, x_max, alpha), _ = \
        got["prep_glove_static"][0]
    ep_args = got["packed_glove_epoch"][0][0]
    Zc1, Zx, N = ep_args[0], ep_args[1], ep_args[-1]
    V2, Kp = G.shape[1], K + 2
    rw = pk.packed_rows(V1, Kp, multiple=ww * n)
    st = ge.prep_glove_shard_static(c2, x2, n2, V1, K, rw, rh, ww, wh, n,
                                    x_max, alpha, shard=p)
    streams = [torch.from_numpy(st[i][0]).to(dev)
               for i in (0, 1, 2, 3, 4, 6, 7, 8, 5)]
    Zc_full = pk.pack_array(pk.unpack_array(Zc1.cpu().numpy(), V1, Kp), Kp,
                            multiple=ww * n)
    kw = dict(lr=m.learning_rate, K=K, rw=rw, rh=rh, wrows_w=ww, wrows_h=wh)

    def fresh():
        Zc = mesh.put_table(Zc_full)
        # AdaGrad's accumulators start at ones (the recorded ones have
        # moved on: the fit updated them in place)
        return Zc, Zx.clone(), {"accum": torch.ones_like(Zc)}, \
            {"accum": torch.ones_like(Zx)}

    # step 0's kernels against their plain forms, on a copy of the state
    keep = {"glove_sample_phase": 1, "sorted_accum": 2}
    rec = record_calls(ge, keep, lambda: sharded_packed_glove_epoch(
        mesh, *fresh(), *streams, N, **kw))
    (Du, Dx), skw = rec["glove_sample_phase"][0]
    check_glove_sample(Du, Dx, skw["Kp"], f"{tag} sharded GloVe step 0")
    for (args, akw), side in zip(rec["sorted_accum"], ("central",
                                                        "context")):
        check_sorted_accum(args, akw, f"{tag} sharded GloVe step 0, {side} "
                           "side")
    del rec, Du, Dx
    Zc, Zxs, oc, oxs = fresh()
    loss, wall, dev_s, peak, launches = mesh_run(lambda: float(
        sharded_packed_glove_epoch(mesh, Zc, Zxs, oc, oxs, *streams, N,
                                   **kw)), mesh)
    got_c = pk.unpack_array(fetch_to_host(Zc, mesh), V1, Kp)
    got_x = Zxs[:V2, :Kp].cpu().numpy()
    want_c, want_x = ge.augment_tables(m.W_central, m.bias, m.W_context,
                                       m.context_bias)
    ec = close(torch.from_numpy(got_c.astype(np.float64)),
               torch.from_numpy(want_c), 2e-3, 2e-5, f"{tag} packed GloVe "
               "central")
    ex = close(torch.from_numpy(got_x.astype(np.float64)),
               torch.from_numpy(want_x), 2e-3, 2e-5, f"{tag} packed GloVe "
               "context")
    loss_close(loss, m.last_loss, f"{tag} packed GloVe")
    ones = bool((got_c[:, K + 1] == 1).all() and (got_x[:, K] == 1).all())
    S = c2.shape[0]
    mesh_model_line(tag, smi, f"packed GloVe epoch (d={K}, {V1} words, {S} "
                    f"steps, Bd={st[-1]})", wall, dev_s, peak,
                    collectives_ms(mesh, [("all_reduce", (rh, 128),
                                           torch.float32)]),
                    f"a step (one all-reduce of {rh * 128 * 4 / 1e6:.3f} MB)",
                    launches)
    warm = warm_epoch(lambda: ct.GloVe(GLOVE_K, batch_size=BATCH,
                                       packed="on", device=dev),
                      lambda g: g.fit(G, num_epochs=1), dev)
    phase(tag, f"packed GloVe: one-device epoch {warm:.4f} s (warm; the "
          f"reference fit's {m.epoch_times_[0]:.4f}); "
          f"gathered central max abs err {ec[0]:.3e}, context {ex[0]:.3e}, "
          f"loss {loss:.7f} against {m.last_loss:.7f}; constant columns "
          f"exactly one: {ones}")
    if launches != {"glove_sample_phase": S, "sorted_accum": 2 * S}:
        raise AssertionError(f"{tag} packed GloVe: launches {launches}")
    if not ones:
        raise AssertionError(f"{tag} packed GloVe: a constant column moved")
    return launches


def mesh_models_direct(mesh, tag, smi) -> dict:
    """The NCCL rank's checks of the four trainers' sharded functions at
    full width; returns their launches."""
    launches = collections.Counter(mesh_wmf(bench_matrix(), mesh, tag, smi))
    launches.update(mesh_expomf(mesh, tag, smi))
    mesh_relmf(mesh, tag, smi)
    G = glove_matrix()
    mesh_glove_batch(G, mesh, tag, smi)
    launches.update(mesh_glove_packed(G, mesh, tag, smi))
    return dict(launches)


@contextlib.contextmanager
def counting(module, names):
    """``module.<name>`` for each of ``names`` counts its calls into the
    dict this yields."""
    calls = collections.Counter()
    origs = {k: getattr(module, k) for k in names}

    def wrap(k):
        def call(*a, **kw):
            calls[k] += 1
            return origs[k](*a, **kw)
        return call

    for k in names:
        setattr(module, k, wrap(k))
    try:
        yield calls
    finally:
        for k, fn in origs.items():
            setattr(module, k, fn)


def mesh_gloo_models(mesh, tag, smi) -> dict:
    """Two gloo ranks on card 0: the public fits of WMF, ExpoMF, RelMF and
    GloVe (fused, kfold, packed) at the quickstart's size (600 x 300; 2,000
    words) against the same fits in a world of one on this rank, every
    fit's sharded function counted and the single-device forms not
    called; then ``dryrun_multichip()``.  Returns the launches."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch import models
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.parallel.dryrun import dryrun_multichip

    dev = mesh.device
    X = quickstart_data().train
    G = glove_matrix(2000, 100_000)
    launches = collections.Counter()
    fits = (
        ("WMF", models.wmf, "sharded_wmf_chunk", "wmf_chunk_solve",
         lambda: ct.WMF(32, chunk_size=64, device=dev), 2),
        ("ExpoMF", models.expomf, "sharded_expomf_chunk", "expomf_chunk",
         lambda: ct.ExpoMF(32, chunk_size=64, device=dev), 1),
        ("RelMF", models.relmf, "sharded_relmf_epoch", "_relmf_epoch",
         lambda: ct.RelMF(8, learning_rate=0.01, batch_size=8192,
                          device=dev), 1),
        ("GloVe fused", models.glove, "sharded_glove_epoch", "_glove_epoch",
         lambda: ct.GloVe(16, batch_size=8192, packed="off", device=dev),
         2),
        ("GloVe kfold", models.glove, "sharded_glove_kfold_epoch",
         "_glove_epoch", lambda: ct.GloVe(16, batch_size=8192,
                                          bias_mode="kfold", device=dev), 2),
        ("GloVe packed", models.glove, "sharded_packed_glove_epoch",
         "packed_glove_epoch", lambda: ct.GloVe(16, batch_size=8192,
                                                packed="on", device=dev), 2))
    for what, module, sharded, single, make, epochs in fits:
        glove = what.startswith("GloVe")
        data = G if glove else X

        def fit(m):
            np.random.seed(0)
            if glove:
                m.fit(data, num_epochs=epochs)
            else:
                m.fit(data, num_epochs=epochs, verbose=False,
                      **({"seed": MESH_SEED} if what == "RelMF" else {}))
            return m

        with world_of_one(dev):
            ref = make()
            if what == "RelMF":
                ref.packed = "off"  # the engine the mesh's "auto" takes
            ref = fit(ref)
        _kernels.reset_launches()
        with counting(module, (sharded, single)) as calls:
            m, wall, dev_s = mesh_timed(lambda: fit(make()))
        launches.update(_kernels.launches)
        tables = (("W_central", "W_context", "bias", "context_bias")
                  if glove else ("W", "H") + (("mu",) if what == "ExpoMF"
                                              else ()))
        errs = []
        for k in tables:
            got, want = (torch.from_numpy(np.asarray(getattr(o, k),
                                                     np.float64))
                         for o in (m, ref))
            errs.append(mesh_close(got, want, 0.01, f"{tag} {what} {k}")
                        if what == "RelMF" else close(
                            got, want, 2e-3, 2e-6 if k == "mu" else 2e-5,
                            f"{tag} {what} {k}")[0])
        phase(tag, f"{smi}; {what} public fit, {epochs} epochs on "
              f"{mesh.num_devices} gloo ranks: wall {wall:.3f} s, device "
              f"{dev_s:.3f} s; max abs err against one device "
              f"{max(errs):.3e}; calls {dict(calls)}; launches "
              f"{dict(_kernels.launches)}")
        if calls[single] or not calls[sharded]:
            raise AssertionError(f"{tag} {what}: calls {dict(calls)}")
    _kernels.reset_launches()
    res, wall, dev_s = mesh_timed(dryrun_multichip)
    launches.update(_kernels.launches)
    phase(tag, f"{smi}; dryrun_multichip: wall {wall:.3f} s, device "
          f"{dev_s:.3f} s; {res}; launches {dict(_kernels.launches)}")
    return dict(launches)


def mesh_rank(argv) -> int:
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank RANK WORLD
    BACKEND DIR``): joins the group through a file store in ``DIR``, runs
    its checks and writes its launch counts to ``DIR``."""
    import datetime

    import torch.distributed as dist

    from cymf_tpu_torch.parallel import MeshContext, use_mesh

    rank, world, backend, d = int(argv[0]), int(argv[1]), argv[2], \
        Path(argv[3])
    dev = torch.device("cuda", rank % torch.cuda.device_count()) \
        if backend == "nccl" else torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = (d / "smi.txt").read_text().strip()
    dist.init_process_group(
        backend, init_method=f"file://{d / f'store_{backend}'}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = MeshContext.create(device=dev)
        tag = f"mesh {backend} {rank}/{world}"
        # the first collective sets the communicator up: time it apart
        t0 = time.perf_counter()
        mesh.barrier()
        phase(tag, f"{smi}; backend {dist.get_backend(mesh.group)}, world "
              f"size {mesh.num_devices}, rank {mesh.rank} on {dev}; first "
              f"collective (the communicator's set-up) "
              f"{time.perf_counter() - t0:.3f} s")
        X = bench_matrix()
        with use_mesh(mesh):
            out = (mesh_direct if backend == "nccl" else mesh_gloo)(
                X, mesh, tag, smi, d)
        (d / f"{backend}_{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_group(world: int, backend: str, d: Path) -> list:
    """Runs ``world`` ranks of ``backend`` as processes, joined within
    ``MESH_TIMEOUT_S`` (a rank that hangs is killed with the others);
    prints their output; raises unless every rank exits 0.  Returns each
    rank's results."""
    for old in d.glob(f"*{backend}*"):
        old.unlink()
    logs = [d / f"log_{backend}_{r}.txt" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), str(world), backend, str(d)], cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for log in logs:
        print(log.read_text(), end="", flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        raise AssertionError(f"mesh {backend}: ranks {hung} hung past "
                             f"{MESH_TIMEOUT_S} s, ranks {failed} failed")
    return [json.loads((d / f"{backend}_{r}.json").read_text())
            for r in range(world)]


def mesh_phase(X, dev, smi) -> dict:
    """Phase 19, mesh: the sharded paths (``cymf_tpu_torch.parallel``)
    at world size ``torch.cuda.device_count()`` over NCCL, then at two
    ranks on card 0 over gloo; returns the ranks' summed launches."""
    import shutil

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    (MESH_DIR / "smi.txt").write_text(smi)
    t0 = time.perf_counter()
    mesh_ref(X, dev, MESH_DIR / "ref.npz")
    phase("mesh", f"single-device references in {time.perf_counter() - t0:.1f}"
          " s")
    launches = collections.Counter()
    n = torch.cuda.device_count()
    for world, backend in ((n, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = mesh_group(world, backend, MESH_DIR)
        for out in ranks:
            launches.update(out["launches"])
        phase("mesh", f"{backend}, {world} ranks: {time.perf_counter() - t0:.1f}"
              f" s; launches summed over the ranks "
              f"{dict(sorted(launches.items()))}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    missing = [k for k in MESH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"mesh: no launch of {missing}")
    return dict(launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2:])
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
    from cymf_tpu_torch import native
    t0 = time.perf_counter()
    path = native.build()
    native.lib()
    phase("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    X = bench_matrix()
    phase("data", f"ML-20M-shaped matrix {X.shape}, {X.count_nonzero()} "
          f"interactions in {time.perf_counter() - t0:.1f} s")
    prep_phase(X)
    results, v4 = check_kernels(X, dev)
    results.update(check_fused_kernels(X, dev))
    wide, ids = check_wide_kernels(X, dev)
    results.update(wide)
    probed, probe_launches = probes(ids, v4, dev)
    results.update(probed)
    del ids, v4
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
    slice_launches = {"bpr-device-prep": bpr_device_prep(X, dev, smi)}
    ms_step = bpr_xla(X, dev, smi)
    if "--profile" in sys.argv[1:]:
        profile_batch_bpr(X, dev, ms_step)
    launches.update(pipeline_fits(X, dev))
    launches.update(bpr_wide(X, dev))
    wide_quickstart(dev)
    als_quickstart(dev)
    wmf_launches, wmf32 = wmf_full_width(X, dev)
    launches.update(wmf_launches)
    relmf_quickstart(dev)
    launches["glove_sample_phase"] = relmf_full(dev)["glove_sample_phase"]
    glove_full(G, dev)
    relmf_xla(dev, smi)
    glove_xla(G, dev, smi)
    batch_quickstart(dev, smi)
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
    del X100k, G5k

    X = bench_matrix()
    recommend_phase(X, dev, smi)
    slice_launches["bf16"] = bf16_phase(X, dev, smi, wmf32)
    del wmf32
    checkpoint_phase(X, dev, smi)
    slice_launches["datasets"] = datasets_phase(dev, smi)
    slice_launches["mesh"] = mesh_phase(X, dev, smi)
    del X

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name],
         "phase_launches": {k: v[name] for k, v in slice_launches.items()
                            if name in v}}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
