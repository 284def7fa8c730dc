"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device: requires CUDA, prints ``nvidia-smi`` name and power limit;
2. build: compiles the CUDA kernels from ``cymf_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the BPR main-path shapes (ML-20M: 138,493 users x 26,744 items,
   20,000,263 interactions, d=20, batch 131,072; first step of the
   port's own prep), the sample kernel also at d=64, with timings;
4. quickstart: BPR on a small synthetic dataset with validation and
   early stopping must beat an untrained model's test DCG@5 by 0.1;
5. full width: 3 epochs of BPR at ML-20M shapes through the public
   ``fit``; every kernel must run once per step.

Then it prints the kernels' JSON line and, last, the device JSON line.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
KERNELS = {
    "bpr_sample_phase": ("cymf_tpu_torch/csrc/bpr_sample.cu",
                         "cymf_tpu/ops/fused_sample.py:317"),
    "sorted_accum": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                     "cymf_tpu/ops/sorted_accum.py:417"),
    "sorted_accum_dual": ("cymf_tpu_torch/csrc/sorted_accum.cu",
                          "cymf_tpu/ops/sorted_accum.py:345"),
}


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
    for name in KERNELS:
        if launches.get(name, 0) != EPOCHS * S:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} "
                                 f"times, expected {EPOCHS * S}")
    if not (np.isfinite(m.last_loss) and np.isfinite(m.W).all()
            and np.isfinite(m.H).all()):
        raise AssertionError("non-finite loss or tables")
    if m.W.shape != (U, 20) or m.H.shape != (I, 20):
        raise AssertionError("tables of the wrong shape")
    return launches


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
    phase("device", f"{torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

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
    quickstart(dev)
    launches = full_width(X, dev)

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
