"""The sorted accumulations, the fused BPR steps and the sequential
epochs of one checkout, timed on one CUDA card.

    python3 accum_timing.py [--repo DIR] [--profile] [--only PREFIXES]

Runs the port in ``DIR`` (a checkout of the repository; this one by
default) through this checkout's ``chip_smoke.py`` helpers, in six
parts:

1. ``sorted_accum`` (#2, and #2w with ``count_lanes``) at the main-path
   calls that ``chip_smoke.py`` checks, each held against
   ``sorted_accum_plain`` first (payload within 1e-5 max|plain|, the count
   granule exact; a mismatch exits non-zero) and timed beside the library
   calls that compute the same function (``index_add_`` of the live rows
   into a zeroed buffer, and ``bincount`` for the counts), both as the
   median of 20 single calls (``time_ms``) and as the mean of 20
   back-to-back calls (``loop_ms``); ``--profile`` adds each call's device
   time by CUDA kernel (``torch.profiler``).
2. The fused steps that share their segmented reduction, at the calls
   that ``chip_smoke.py`` checks: the v6 block step (#5) on step 0 of
   the ml-1m stream at ``wrows`` 512, the v7 range step (#6) on ML-20M
   step 0 and on the last step (its padding tail), the v8 pool step (#7,
   P = 1024) on ML-20M step 0.  Each is held against its plain version
   first (``chip_smoke.check_fused``: Aw and Apool lane group by lane
   group, Q rtol 1e-5 and atol 1e-6), then timed by call and in a loop
   and, with ``--profile``, by device time a call, by CUDA kernel; a hash
   of Aw's and Q's bits is printed, with whether two calls agree, which
   two checkouts share where they sum in the same order.
3. ``sorted_accum_dual`` (#3, and #3w with ``count_lanes``) at the
   main-path calls that ``chip_smoke.py`` checks (ML-20M step 0's H side
   at d=20, ``wrows`` 256 and 512; at d=256 and d=300, widths 256 and 384
   with the count granule), each held against ``sorted_accum_dual_plain``
   first (``chip_smoke.dual_against_plain``: payload within 1e-5
   max|plain|, the count granule exact) and timed by call, in a loop and
   by device time a call, by CUDA kernel (no single library call computes
   its function).
4. The sequential kernels (#10-#12, ``pallas_engine``) at the launches
   that ``chip_smoke.py``'s ``pallas-full`` phase makes: BPR's epoch
   launch and its 10-epoch launch (a fit without a validator), RelMF's
   epoch (1,586,126 cells of ml-100k) and GloVe's (5,000 words), each from
   the fit's starting tables: the median of 5 CUDA-event timings of the
   wrapper, ns a group.
5. The phases of ``chip_smoke.py`` that call them most, as it runs them,
   in this order: ``relmf-ml20m`` (1,000
   device-prep RelMF steps: 2,000 calls of #2; ms a step), before and
   after ``full`` (3 epochs of BPR d=20 at ML-20M through ``fit``,
   pipeline v4: 453 calls of #2 and #3 each), and ``bpr-wide`` (2 epochs
   of BPR d=256: 302 calls of #2w and #3w each); each epoch's host prep
   and device seconds are printed.  ``--profile`` adds the card's busy
   share of the RelMF steps after ``full`` and their device time by
   kernel (``chip_smoke.profile_relmf``).

6. The row gather P3 (``probes.gather_rows``, sites named ``P3 ...``) at
   ``chip_smoke.gather_sites``' eleven sites (the script's shapes, the
   wide step's two gathers, the v4 step's five), each on a table of the
   site's shape made from a seed on the card: the same bits as
   ``gather_rows_plain``, then the kernel's and ``index_select``'s times
   by call, in a loop and by device time, beside the bound
   (``chip_smoke.gather_against_library``).

``--only '#5,#6,#7,bpr-v7'`` times only the sites whose names start with
one of the prefixes given and runs only the phases named, in that order;
``bpr-v7`` is ``chip_smoke.py``'s phase of that name (``fit`` under
``CYMF_TPU_PACKED_KERNEL=7``) run for 2 epochs, the second one steady.
To compare two checkouts (a ``git
archive`` of the other unpacked under ``build/``), run them in turns in
one command, A, B, B, A, and compare within it (``--only P3`` for the
gather alone).  The call sites' inputs are built the first time (ML-20M
shapes: ~1 min of host work; the P3 sites' ids apart, and only when
asked for) and kept in ``build/`` under a hash of ``chip_smoke.py`` and
this script, so that every run of the command times the same tensors.  Prints the card's name
and power limit and, last, one JSON line of the call sites' times and
the RelMF steps (before and after ``full``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPS = 20


def build_inputs(dev):
    """``{site: (args, kw)}`` of the single-stream calls, the dual calls
    (sites named ``#3...``), the fused steps (``#5...``-``#7...``) and the
    sequential launches (``#10``-``#12``), on the CPU."""
    import chip_smoke as cs
    from cymf_tpu_torch.ops import fused_sample as fs
    from cymf_tpu_torch.ops import glove_epoch as ge
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.models.sgd import epoch_generator
    from cymf_tpu_torch.ops import relmf_epoch as tre
    from cymf_tpu_torch.ops import sorted_accum as sa

    X = cs.bench_matrix()
    sites = {}
    t, rw, rh = cs.first_step(X, 20, dev)
    SW, Q, _ = fs.bpr_sample_phase_plain(t["Du"], t["Di"], t["Dj"], K=20,
                                         wd=0.01)
    sites["#2 ML-20M d=20 step 0, W side"] = (
        (t["phys"], SW, t["winw"][0], t["winw"][1]),
        dict(r_pad=rw, wrows=cs.WROWS))
    fused_kw = dict(K=20, wd=0.01, rw=rw, wrows=cs.WROWS)
    sites["#6 ML-20M d=20 step 0"] = (cs.range_step_args(t, 20, rw, rh, dev),
                                      fused_kw)
    sites["#7 ML-20M d=20 step 0, P 1024"] = (
        cs.pool_step_args(t, 20, rw, rh, dev), fused_kw)
    sides = (t["rowsi"], Q.index_select(0, t["si"]), t["rowsj"],
             Q.index_select(0, t["sj"]))
    sites["#2 ML-20M d=20 step 0, i side (v8's item-side stream)"] = (
        (*sides[:2], t["wini"][0], t["wini"][1]),
        dict(r_pad=rh, wrows=cs.WROWS))
    sites[f"#3 ML-20M d=20 step 0, H side, wrows {cs.WROWS}"] = (
        (*sides[:2], t["wini"][0], t["wini"][1], *sides[2:],
         t["winj"][0], t["winj"][1]),
        dict(r_pad=rh, neg_lanes=20, wrows=cs.WROWS))
    rh5 = pk.logical_rows(cs.I, multiple=512)
    args = []
    for rows, g in (sides[:2], sides[2:]):
        args += [rows, g] + [torch.from_numpy(a).to(dev) for a in
                             sa.window_ranges(rows.reshape(-1).cpu().numpy(),
                                              rh5, 512, 1024, align=128)]
    sites["#3 ML-20M d=20 step 0, H side, wrows 512"] = (
        tuple(args), dict(r_pad=rh5, neg_lanes=20, wrows=512))
    del t, SW, Q, sides, args
    t, rw, rh = cs.first_step(X, 20, dev, -1)
    sites[f"#6 ML-20M d=20 last step, {int((t['phys'] >= rw).sum())} "
          "padding samples"] = (cs.range_step_args(t, 20, rw, rh, dev),
                                fused_kw)
    del t
    sites["#5 ml-1m d=20 step 0, wrows 512"] = cs.ml1m_step_args(
        cs.ml1m_matrix(), dev, 512)
    wide = cs.wide_step0(X, dev)
    for K in (cs.WIDE_K, 300):
        w_args, h_args, rw, rh = wide[K]
        width = w_args[1].shape[1]
        sites[f"#2w ML-20M d={K} step 0, W side, width {width}"] = (
            w_args, dict(r_pad=rw, wrows=cs.WIDE_WROWS, count_lanes=True))
        sites[f"#3w ML-20M d={K} step 0, H side, width {width}"] = (
            h_args, dict(r_pad=rh, neg_lanes=width, wrows=cs.WIDE_WROWS,
                         count_lanes=True))
    del wide
    st = cs.relmf_ml20m_state(X, dev)
    del X

    def relmf_step0():
        tre.packed_relmf_epoch_device(
            st["Wp"].clone(), st["Hp"].clone(),
            {k: v.clone() for k, v in st["ow"].items()},
            {k: v.clone() for k, v in st["oh"].items()}, st["hs"],
            epoch_generator(1234, 0, dev), 1, 1.0, **st["kw"])

    def glove_epoch0():
        import cymf_tpu_torch as ct
        np.random.seed(0)
        ct.GloVe(cs.GLOVE_K, batch_size=cs.BATCH, device=dev).fit(
            cs.glove_matrix(), num_epochs=1)

    for module, run, what in ((tre, relmf_step0, "RelMF ML-20M step 0"),
                              (ge, glove_epoch0, "GloVe 50k-word step 0")):
        got = cs.record_calls(module, {"sorted_accum": 2}, run)
        for call, side in zip(got["sorted_accum"], ("W", "H")):
            sites[f"#2 {what}, {side} side"] = call
    seq = cs.seq_launches(cs.ml100k_matrix(),
                          cs.glove_matrix(cs.GLOVE_SMALL_V,
                                          cs.GLOVE_SMALL_NNZ), dev)
    sites["#10 BPR ml-100k epoch launch"] = seq["bpr_pallas_epoch"][0]
    sites["#10 BPR ml-100k 10-epoch launch"] = seq["bpr_pallas_epoch"][1]
    sites["#11 RelMF ml-100k epoch launch"] = seq["relmf_pallas_epoch"][0]
    sites["#12 GloVe 5,000-word epoch launch"] = seq["glove_pallas_epoch"][0]
    return {k: (tuple(a.cpu() if torch.is_tensor(a) else a for a in args),
                kw) for k, (args, kw) in sites.items()}


def gather_inputs(dev):
    """``{site: ((R, W, ids), {})}`` of P3's sites
    (``chip_smoke.gather_sites``: the script's shapes, the wide step's
    gathers at width 256 and the v4 step's five), the ids on the CPU; the
    tables are made at run time (:func:`time_gather`)."""
    import chip_smoke as cs
    from cymf_tpu_torch.ops import fused_sample as fs

    X = cs.bench_matrix()
    t, rw, _ = cs.first_step(X, 20, dev)
    _, Q, _ = fs.bpr_sample_phase_plain(t["Du"], t["Di"], t["Dj"], K=20,
                                        wd=0.01)
    v4 = cs.v4_gathers(t, Q, rw)
    ids = cs.wide_step0(X, dev, Ks=(cs.WIDE_K,))["ids"]
    return {f"P3 {what}": ((T.shape[0], T.shape[1], ix.cpu()), {})
            for what, T, ix in cs.gather_sites(ids, v4, dev)}


def time_gather(what, args) -> dict:
    """One P3 site on a float32 table of its shape, made from a seed on
    the card (a gather's time does not depend on the values):
    ``chip_smoke.gather_against_library``, printed."""
    import chip_smoke as cs

    R, W, ix = args
    gen = torch.Generator(ix.device).manual_seed(0)
    T = torch.randn((R, W), generator=gen, device=ix.device)
    res = cs.gather_against_library(T, ix, what[3:], REPS)
    print(res.pop("line"), flush=True)
    return res


def inputs_path(kind: str = "accum") -> Path:
    """The cached call sites (``kind`` ``accum`` or ``gather``), keyed by
    the helpers that build them."""
    h = hashlib.sha256()
    for name in ("chip_smoke.py", "accum_timing.py"):
        h.update((ROOT / name).read_bytes())
    return ROOT / "build" / f"{kind}_inputs_{h.hexdigest()[:16]}.pt"


def time_dual(what, args, kw) -> dict:
    """One dual call site: ``chip_smoke.dual_against_plain``, printed."""
    import chip_smoke as cs

    res = cs.dual_against_plain(args, kw, what, REPS)
    print(f"{what} (B={args[1].shape[0]} + {args[5].shape[0]}, width "
          f"{args[1].shape[1]}, r_pad {kw['r_pad']}): kernel "
          f"{res['ms']:.4f} ms a call, {res['loop_ms']:.4f} ms in a loop, "
          f"device {res['device_ms']:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in res["split_ms"].items())
          + f"); bound {res['bound_ms']:.4f} ms; max abs "
          f"{res['max_abs_err']:.3e} (limit {res['limit']:.3e})", flush=True)
    return res


_FUSED = {"#5": "bpr_block_step_v6", "#6": "bpr_range_step_v7",
          "#7": "bpr_pool_step_v8"}


def time_fused(what, args, kw, profile: bool) -> dict:
    """One fused step call site (#5-#7, which share the dual's
    ``segment.cuh``): held against its plain version first
    (``chip_smoke.check_fused``: Aw by lane group, Apool likewise, Q rtol
    1e-5 and atol 1e-6), timed by call and in a loop, and with
    ``profile`` by device time a call, by CUDA kernel; printed with a hash
    of Aw's and Q's bits on two calls (whether they agree is recorded, not
    required: a checkout with another design may sum in another order
    each call), which two checkouts share where they sum in the same
    order."""
    import chip_smoke as cs

    from cymf_tpu_torch.ops import fused_step as fst
    from cymf_tpu_torch.ops import packed as pk

    name = _FUSED[what.split()[0]]
    fn, plain = getattr(fst, name), getattr(fst, name + "_plain")
    K = kw["K"]
    # chip_smoke.check_fused_kernels' count: per sample the slot
    # extraction and placement and ~21 operations a lane (v8 ~22)
    ops = args[2].shape[0] * 128 * (2 * pk.num_slots(K) + (
        22 if name == "bpr_pool_step_v8" else 21))
    rows = ("rows", 1e-5, 1e-6)
    outs, limits, bits = (("Aw", "Q"), (("lanes", cs.aw_lanes(K)), rows),
                          (0, 1))
    if name == "bpr_pool_step_v8":
        outs, limits, bits = (("Aw", "Apool", "Q"), (
            ("lanes", cs.aw_lanes(K)), ("lanes", cs.apool_lanes(K)), rows),
            (0, 2))
    res = cs.check_fused(what, fn, plain, args, kw, outs, limits,
                         cs.nbytes(*args), ops)
    hashes = [{outs[i]: hashlib.sha256(got[i].cpu().numpy().tobytes())
               .hexdigest()[:16] for i in bits}
              for got in (fn(*args, **kw), fn(*args, **kw))]
    res["bits"], res["same_bits_two_calls"] = hashes[0], hashes[0] == hashes[1]
    line = (f"{what}: {res['ms']:.4f} ms a call, {res['loop_ms']:.4f} ms "
            f"in a loop; bits " + ", ".join(f"{k} {v}" for k, v in
                                            res["bits"].items())
            + f", the same on two calls: {res['same_bits_two_calls']}")
    if profile:
        split = cs.device_split(lambda: fn(*args, **kw), REPS)
        res.update(device_ms=sum(split.values()), split_ms=split)
        line += (f"; device {res['device_ms']:.4f} ms ("
                 + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + ")")
    print(line, flush=True)
    return res


_SEQ = {"#10": "bpr_pallas_epoch", "#11": "relmf_pallas_epoch",
        "#12": "glove_pallas_epoch"}


def time_seq(what, args, kw) -> dict:
    """One sequential launch: ``chip_smoke.seq_launch_ms`` (the median
    of 5 CUDA-event timings of the wrapper from the fit's starting
    tables), printed with ns a group."""
    import chip_smoke as cs

    from cymf_tpu_torch.ops import pallas_engine as pe

    fn = getattr(pe, _SEQ[what.split()[0]])
    ms = cs.seq_launch_ms(fn, args, kw)
    groups = args[2].numel() // kw["group"]
    print(f"{what} ({args[2].numel()} samples, {groups} groups of "
          f"{kw['group']}): {ms:.3f} ms, {1e6 * ms / groups:.1f} ns a group",
          flush=True)
    return dict(ms=ms, groups=groups)


def time_site(what, args, kw) -> dict:
    """One single-stream call site: ``chip_smoke.accum_against_library``,
    printed."""
    import chip_smoke as cs

    res = cs.accum_against_library(args, kw, what, REPS)
    print(f"{what} (B={args[1].shape[0]}, width {args[1].shape[1]}, r_pad "
          f"{kw['r_pad']}): kernel {res['ms']:.4f} ms a call, "
          f"{res['loop_ms']:.4f} ms in a loop; library "
          f"{res['library_ms']:.4f} / {res['library_loop_ms']:.4f} ms; "
          f"bound {res['bound_ms']:.4f} ms; max abs "
          f"{res['max_abs_err']:.3e} (limit {res['limit']:.3e})", flush=True)
    return res


def profile_site(what, args, kw) -> dict:
    """Device time of each CUDA kernel (and memset) of a single-stream
    call, per call (``chip_smoke.device_split``)."""
    import chip_smoke as cs

    from cymf_tpu_torch.ops import sorted_accum as sa

    split = cs.device_split(lambda: sa.sorted_accum(*args, **kw), REPS)
    print(f"{what}: device ms a call by kernel "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose cymf_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split each single-stream and fused site's "
                         "kernel calls by CUDA kernel with torch.profiler")
    ap.add_argument("--only", default="",
                    help="comma-separated site prefixes (e.g. '#5,#6,#7' "
                         "or 'P3') and phase names (relmf-ml20m, full, "
                         "bpr-wide, bpr-v7): time only those, in that order")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("accum_timing: no CUDA device", file=sys.stderr)
        return 1
    # the timed package first, so that this checkout's chip_smoke helpers
    # use it too
    sys.path.insert(0, str(opts.repo.resolve()))
    import cymf_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["chip_smoke"])
    from cymf_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    print(f"package {Path(cymf_tpu_torch.__file__).parent}, library "
          f"{_kernels.build().name}", flush=True)
    _kernels.lib()
    only = tuple(p for p in opts.only.split(",") if p)
    prefixes = tuple(p for p in only if p.startswith(("#", "P3")))
    sites = {}
    for kind, build, wanted in (
            ("accum", build_inputs, not only or any(
                p.startswith("#") for p in prefixes)),
            ("gather", gather_inputs, not only or any(
                p.startswith("P3") for p in prefixes))):
        cache = inputs_path(kind)
        if wanted and not cache.exists():
            cache.parent.mkdir(parents=True, exist_ok=True)
            torch.save(build(dev), cache)
        if wanted:
            sites.update(torch.load(cache))
    out = {}
    for what, (args, kw) in sites.items():
        if only and not what.startswith(prefixes):
            continue
        args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
        if what.startswith("P3"):
            out[what] = time_gather(what, args)
            continue
        if what.split()[0] in _FUSED:
            out[what] = time_fused(what, args, kw, opts.profile)
            continue
        if what.startswith("#3"):
            out[what] = time_dual(what, args, kw)
            continue
        if what.split()[0] in _SEQ:
            out[what] = time_seq(what, args, kw)
            continue
        out[what] = time_site(what, args, kw)
        if opts.profile:
            out[what]["split_ms"] = profile_site(what, args, kw)
    del sites, args
    cs = sys.modules["chip_smoke"]
    phases = [p for p in only if p not in prefixes] if only else [
        "relmf-ml20m", "full", "relmf-ml20m", "bpr-wide"]
    X = cs.bench_matrix() if phases else None
    st, relmf_ms = None, []
    for i, name in enumerate(phases):
        if name == "relmf-ml20m":
            st = st or cs.relmf_ml20m_state(X, dev)
            relmf_ms.append(cs.relmf_ml20m(st, dev))
            if "relmf-ml20m" in phases[i + 1:]:
                continue
            if opts.profile:
                cs.profile_relmf(st, dev, relmf_ms[-1])
                print((cs.ROOT / "chiprun_out" / "relmf_profile.txt")
                      .read_text().split("\n\n")[0], flush=True)
            st = None       # its tables leave the card before later phases
        elif name == "full":
            cs.full_width(X, dev)
        elif name == "bpr-wide":
            cs.bpr_wide(X, dev)
        elif name == "bpr-v7":
            with cs.forced_kernel("7"):
                cs.bpr_fit(X, dev, 2, "bpr-v7", 7, {"bpr_range_step_v7": 1,
                                                    "sorted_accum_dual": 1})
        else:
            raise SystemExit(f"accum_timing: no phase {name!r}")
    print(json.dumps({"repo": str(opts.repo), "sites": out,
                      "relmf_ml20m_ms_a_step": relmf_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
