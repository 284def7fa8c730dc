"""Where a sequential epoch's group step goes, on one CUDA card.

    python3 seq_split.py [--repo DIR] [--variants] [--placements P,P,...]

Times the sequential kernels (#10-#12, ``csrc/seq_epoch.cu``) of the port
in ``DIR`` (a checkout of the repository; this one by default) at the
launches that ``chip_smoke.py``'s ``pallas-full`` phase makes (RelMF's
epoch, 198,656 groups of 8 under adam; BPR's epoch and 10-epoch launch;
GloVe's epoch, adagrad), the median of 3 CUDA-event timings from the
fit's starting tables (``chip_smoke.seq_launch_ms``), in ms and ns a
group:

- ``--variants``: builds variants of ``DIR``'s ``seq_epoch.cu`` into
  ``build/seq_split/``, each with one piece of the group step removed,
  and times each in place of the checkout's kernel.  The edits match the
  source text of two kernels, and the script uses the set whose anchors
  it finds: the first port's kernel (the index loads, the winner loop,
  the loss loop, the rows' L2 round trip, the optimizer arithmetic, all
  five: its chain floor; run it with ``--repo`` on a checkout of commit
  065ef37, the last with that kernel) and the staged kernel that replaced
  it (the optimizer arithmetic, the dot products' shuffles, the chain's
  second barrier, all three).  A variant computes wrong tables: only its
  time means anything.
- ``--placements``: the checkout's wrappers at each forced placement
  (their private ``_placement``), on the full tables and on catalogs cut
  to fit one block's shared memory (BPR and RelMF 500 users x 360 items,
  GloVe 240 words; indices taken modulo the cut, BPR's samples with
  i = j masked).

Prints the card's name and power limit and, last, one JSON line of the
times.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "seq_split"
SITES = {"RelMF epoch": ("relmf_pallas_epoch", 0),
         "BPR epoch": ("bpr_pallas_epoch", 0),
         "BPR 10-epoch": ("bpr_pallas_epoch", 1),
         "GloVe epoch": ("glove_pallas_epoch", 0)}
CUT = {"relmf_pallas_epoch": (500, 360), "bpr_pallas_epoch": (500, 360),
       "glove_pallas_epoch": (240, 240)}
NO_OPT = ("                                         const Hyper& h) {\n",
          "                                         const Hyper& h) {\n"
          "  return;\n")


def _first_port_variants() -> dict:
    """Edits of the first port's kernel: ``{name: [(old, new), ...]}``;
    an edit ``(old, new, n)`` replaces all ``n`` places of ``old``."""
    stage = ("  __shared__ int s_ia[512], s_ib[512], s_ij[512], "
             "s_keep[512];\n  __shared__ float s_fa[512], s_fb[512];\n"
             "  for (int q = threadIdx.x; q < 512; q += blockDim.x) {\n"
             "    s_ia[q] = ia[q]; s_ib[q] = ib[q]; s_keep[q] = keep[q];\n"
             "    s_ij[q] = ij ? ij[q] : 0; s_fa[q] = fa ? fa[q] : 0.f;\n"
             "    s_fb[q] = fb ? fb[q] : 0.f;\n  }\n  __syncthreads();\n")
    terms = "  __shared__ float terms[MAX_GROUP];\n"
    idx = [(terms, terms + stage),
           ("    const long long b = g * G + t;\n",
            "    const long long b = (g * G + t) & 511;\n"),
           ("keep[b] != 0", "s_keep[b] != 0"),
           ("const int a = ia[b];", "const int a = s_ia[b];"),
           ("const int c = ib[b];", "const int c = s_ib[b];"),
           ("? ij[b] : 0", "? s_ij[b] : 0"),
           ("const float w = fa[b];", "const float w = s_fa[b];"),
           ("const float f = fa[b];", "const float f = s_fa[b];"),
           ("fb[b]);", "s_fb[b]);")]
    win = [("      for (int t2 = t + 1; t2 < G; ++t2) {\n",
            "      for (int t2 = G; t2 < G; ++t2) {\n")]
    loss = [("    if (threadIdx.x == 0) {\n      float s = 0.f;",
             "    if (false) {\n      float s = 0.f;")]
    # rows in shared memory: row r -> r % 32 of a table in dynamic shared
    # memory, filled with 0.01
    rows = [(terms, terms + "  extern __shared__ float4 smtab4[];\n"
             "  float* smA = reinterpret_cast<float*>(smtab4);\n"
             "  float* smB = smA + 32 * (1 + NS) * Kp;\n"
             "  for (int q = threadIdx.x; q < 2 * 32 * (1 + NS) * Kp; "
             "q += blockDim.x)\n    smA[q] = 0.01f;\n  __syncthreads();\n")]
    for fn in ("load_row", "store_row"):
        for r, T, v in (("ra", "A", "a"), ("rb", "B", "c"), ("rc", "B", "d")):
            rows.append((f"{fn}({r}, {T}, {v}, ",
                         f"{fn}({r}, sm{T}, {v} % 32, "))
    for k in range(3):
        rows.append((f"seq_epoch_kernel<MODEL, {k}><<<1, block, 0, stream>>>",
                     f"seq_epoch_kernel<MODEL, {k}><<<1, block, "
                     f"2 * 32 * (1 + {k}) * Kp * 4, stream>>>"))
    return {"index loads": idx, "winner loop": win, "loss loop": loss,
            "rows' L2 trip": rows, "optimizer arithmetic": [NO_OPT],
            "all five (chain floor)": idx + win + loss + rows + [NO_OPT]}


def _staged_variants() -> dict:
    """Edits of the staged kernel (stager warp, placements)."""
    shuffles = [("warp_sum(dot<CW>(", "(dot<CW>(", 3),
                ("warp_sum(add(", "(add(", 2)]
    barrier = [("        bar_sync(CHAIN, chain);  // the stores are visible "
                "to the next group\n", "")]
    return {"optimizer arithmetic": [NO_OPT], "dot shuffles": shuffles,
            "second barrier": barrier,
            "all three": [NO_OPT] + shuffles + barrier}


def _apply(src: str, edits) -> str:
    for old, new, *count in edits:
        n = src.count(old)
        if n != (count or [1])[0]:
            raise ValueError(f"edit anchor found {n} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(src: Path, entries) -> dict:
    """``{name: ctypes library}`` of the variants of ``src``, each built by
    one ``nvcc`` process, all started together."""
    from cymf_tpu_torch.ops import _kernels

    text = src.read_text()
    table = (_first_port_variants() if "for (int t2 = t + 1; t2 < G; ++t2)"
             in text else _staged_variants())
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, (name, edits) in enumerate(table.items()):
        cu, so = OUT / f"v{k}.cu", OUT / f"libv{k}.so"
        cu.write_text(_apply(text, edits))
        cmd = [_kernels._nvcc(), _kernels.ARCH, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", f"-I{src.parent}", "-o",
               str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, p) in jobs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
        h = ctypes.CDLL(str(so))
        for e in entries:
            getattr(h, e).argtypes = _kernels._SIGNATURES[e]
            getattr(h, e).restype = ctypes.c_int
        libs[name] = h
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=ROOT,
                    help="checkout whose cymf_tpu_torch is timed")
    ap.add_argument("--variants", action="store_true",
                    help="time variants with one piece of the step removed")
    ap.add_argument("--placements", default="",
                    help="comma-separated placements to force")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("seq_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(opts.repo.resolve()))
    import cymf_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops import pallas_engine as pe

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    own = _kernels.lib()
    print(f"package {Path(cymf_tpu_torch.__file__).parent}", flush=True)
    libs = {"the checkout's kernel": own}
    if opts.variants:
        entries = [e for e in _kernels._SIGNATURES if "seq_epoch" in e
                   and e != "cymf_seq_epoch_plan"]
        libs.update(build_variants(
            opts.repo / "cymf_tpu_torch" / "csrc" / "seq_epoch.cu", entries))
    launches = cs.seq_launches(cs.ml100k_matrix(), cs.glove_matrix(
        cs.GLOVE_SMALL_V, cs.GLOVE_SMALL_NNZ), dev)
    out = {}
    for what, (name, which) in SITES.items():
        args, kw = launches[name][which]
        fn = getattr(pe, name)
        groups = args[2].numel() // kw["group"]
        res = out[what] = {}
        try:
            for vname, h in libs.items():
                _kernels._lib = h   # the wrappers launch through lib()
                ms = res[vname] = cs.seq_launch_ms(fn, args, kw, reps=3)
                print(f"{what} ({groups} groups of {kw['group']}): {vname} "
                      f"{ms:.3f} ms, {1e6 * ms / groups:.1f} ns a group",
                      flush=True)
        finally:
            _kernels._lib = own
        for p in (int(x) for x in opts.placements.split(",") if x):
            if which:
                continue
            ra, rb = CUT[name]
            cut = [args[0][:ra].clone(), args[1][:rb].clone()]
            st = [args[2] % ra, args[3] % rb] + list(args[4:])
            if name == "bpr_pallas_epoch":
                st[2] = args[4] % rb
                st[3] = st[3] * (st[1] != st[2]).int()
            for tag, T, S in (("full", args[:2], args[2:]), ("cut", cut, st)):
                try:
                    ms = cs.seq_launch_ms(fn, (*T, *S),
                                          dict(kw, _placement=p), reps=3)
                except RuntimeError as e:   # tables over the placement
                    print(f"{what}: placement {p}, {tag} tables: {e}")
                    continue
                res[f"placement {p}, {tag} tables"] = ms
                print(f"{what}: placement {p}, {tag} tables "
                      f"{tuple(T[0].shape)} {tuple(T[1].shape)}: {ms:.3f} "
                      f"ms, {1e6 * ms / groups:.1f} ns a group", flush=True)
    print(json.dumps({"repo": str(opts.repo), "sites": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
