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
   d=64.  The batched Cholesky on the first diagonal block (C=2048, B=64)
   of the first standard-form user chunk of the WMF d=256 fit, and at
   C=1, C=262 and B=128;
4. quickstart: BPR on a small synthetic dataset with validation and
   early stopping must beat an untrained model's test DCG@5 by 0.1;
5. full width: 3 epochs of BPR at ML-20M shapes through the public
   ``fit``; every BPR kernel must run once per step;
6. ALS quickstart: WMF d=128 must beat an untrained model's test DCG@5 by
   0.1 through the Cholesky kernel; WMF and ExpoMF d=128 must match the
   same fits with the plain diagonal factor (``CYMF_TPU_ALS_CHOL=blocked``);
7. WMF full width: 2 epochs of WMF d=256 at ML-20M shapes through the
   public ``fit``; the Cholesky kernel must run K/64 = 4 times per
   standard-form chunk.

Then it prints the kernels' JSON line and, last, the device JSON line.
``--profile`` adds a ``torch.profiler`` split of one WMF d=256 epoch,
written to ``chiprun_out/wmf_profile.txt``.  Imports nothing of JAX.
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
KERNELS = {**BPR_KERNELS,
           "chol_inv_batched": ("cymf_tpu_torch/csrc/chol_inv.cu",
                                "cymf_tpu/ops/chol_kernel.py:109")}
ALS_TOL = dict(rtol=2e-3, atol=2e-4)


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


def first_step(X, K: int, dev):
    """Inputs of the three kernels at step 0 of the port's prep over X."""
    from cymf_tpu_torch.models.bpr import sorted_batches
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.fused_sample import decorate
    from cymf_tpu_torch.ops.packed_epoch import prep_epoch, prep_static

    u2, i2 = sorted_batches(X, BATCH)
    u2, i2 = u2[:1], i2[:1]
    rw = pk.packed_rows(U, K, multiple=WROWS)
    rh = pk.logical_rows(I, multiple=WROWS)
    winw, si, rowsi, wini = prep_static(u2, i2, K, rw, rh, WROWS, WROWS)
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
    return t, rw, rh


def check_kernels(X, dev):
    """Phase 3: every kernel against its plain version on the card."""
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import sorted_accum as sa

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
            results["bpr_sample_phase"] = dict(
                max_abs_err=max(e_sw[0], e_q[0]), ms=ms, plain_ms=pms)
            msg += f"; {ms:.4f} ms vs plain {pms:.4f} ms"
        phase("kernels", msg)
        if K != 20:
            continue

        w_args = (t["phys"], SW, t["winw"][0], t["winw"][1])
        Aw = sa.sorted_accum(*w_args, r_pad=rw, wrows=WROWS)
        Awp = sa.sorted_accum_plain(*w_args, r_pad=rw, wrows=WROWS)
        h_args = (t["rowsi"], Q.index_select(0, t["si"]), t["wini"][0],
                  t["wini"][1], t["rowsj"], Q.index_select(0, t["sj"]),
                  t["winj"][0], t["winj"][1])
        D = sa.sorted_accum_dual(*h_args, r_pad=rh, neg_lanes=K,
                                 wrows=WROWS)
        Dp = sa.sorted_accum_dual_plain(*h_args, r_pad=rh, neg_lanes=K,
                                        wrows=WROWS)
        torch.cuda.synchronize()
        for name, got, want, fn, plain, kw, a in (
                ("sorted_accum", Aw, Awp, sa.sorted_accum,
                 sa.sorted_accum_plain, dict(r_pad=rw, wrows=WROWS), w_args),
                ("sorted_accum_dual", D, Dp, sa.sorted_accum_dual,
                 sa.sorted_accum_dual_plain,
                 dict(r_pad=rh, neg_lanes=K, wrows=WROWS), h_args)):
            scale = float(want.abs().max())
            e = close(got, want, 0.0, 1e-5 * scale, name)
            ms = time_ms(lambda: fn(*a, **kw))
            pms = time_ms(lambda: plain(*a, **kw))
            results[name] = dict(max_abs_err=e[0], ms=ms, plain_ms=pms)
            phase("kernels", f"{name}: max abs {e[0]:.3e} (limit "
                  f"{1e-5 * scale:.3e} = 1e-5 max|plain|), max rel "
                  f"{e[1]:.3e}; {ms:.4f} ms vs plain {pms:.4f} ms")
    return results


def quickstart(dev):
    """Phase 4: the README quickstart on the card."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset

    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    valid = ct.AoaEvaluator(d.valid, d.train, metrics=["DCG"], k=5,
                            device=dev)
    test = ct.AoaEvaluator(d.test, d.train, k=5, device=dev)
    m0 = ct.BPR(20, learning_rate=0.01, weight_decay=0.01, device=dev)
    m0.fit(d.train, num_epochs=0, verbose=False)
    base = test.evaluate(m0.W, m0.H)["DCG@5"]
    m = ct.BPR(20, learning_rate=0.01, weight_decay=0.01, device=dev)
    m.fit(d.train, num_epochs=30, valid_evaluator=valid, early_stopping=True,
          verbose=False)
    res = test.evaluate(m.W, m.H)
    phase("quickstart", f"test {res}; untrained DCG@5 {base:.4f}; best "
          f"valid DCG@5 {m.valid_dcg:.4f}; last loss {m.last_loss:.4f}")
    if not res["DCG@5"] >= base + 0.1:
        raise AssertionError("the quickstart did not learn")


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
    """Phase 5: 3 epochs of the public fit at ML-20M shapes."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.ops import _kernels

    m = ct.BPR(num_components=20, learning_rate=0.001, optimizer="adam",
               weight_decay=0.01, batch_size=BATCH, device=dev)
    probe = _DeviceProbe(m)
    N = X.count_nonzero()
    S = -(-N // BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m.fit(X, num_epochs=EPOCHS, valid_evaluator=probe, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    for e, st in enumerate(m.epoch_times_):
        phase("full", f"epoch {e}: host prep {st['prep_s']:.3f} s, device "
              f"{st['device_s']:.3f} s, {N / st['device_s']:.4e} int/s "
              f"device, {N / (st['prep_s'] + st['device_s']):.4e} int/s "
              "prep+device")
    phase("full", f"fit wall {wall:.2f} s (incl. once-per-fit prep), peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}"
          f" GiB, last loss {m.last_loss:.6f}, launches {launches}, "
          f"S={S}")
    if probe.calls != EPOCHS:
        raise AssertionError("the device probe did not run every epoch")
    for name in BPR_KERNELS:
        if launches.get(name, 0) != EPOCHS * S:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} "
                                 f"times, expected {EPOCHS * S}")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()
            and np.isfinite(m.H).all()):
        raise AssertionError("non-finite loss or tables")
    if m.W.shape != (U, 20) or m.H.shape != (I, 20):
        raise AssertionError("tables of the wrong shape")
    return launches


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
        pms = time_ms(lambda: ck.chol_inv_batched_plain(blk))
        phase("kernels", f"chol_inv_batched {what} {tuple(blk.shape)} "
              f"(first standard user chunk, P={P}): max abs dL {err:.3e} "
              f"(limit {lim:.3e}), |Linv L - I| {inv_err:.3e} (limit "
              f"1e-3); {ms:.4f} ms vs plain {pms:.4f} ms")
        if err > lim or inv_err > 1e-3 or upper:
            raise AssertionError(f"chol_inv_batched {what} disagrees")
        if out is None:
            out = dict(max_abs_err=err, ms=ms, plain_ms=pms)
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
    results["chol_inv_batched"] = check_chol(X, dev)
    quickstart(dev)
    launches = full_width(X, dev)
    als_quickstart(dev)
    launches.update(wmf_full_width(X, dev))
    if "--profile" in sys.argv[1:]:
        profile_wmf(X, dev)

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
