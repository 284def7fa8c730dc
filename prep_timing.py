"""The BPR fits' native host prep beside the card's epochs, timed on one
CUDA card.

    python3 prep_timing.py [--epochs N] [--threads 8,7] [--wide]

Runs ``BPR(20).fit`` at ML-20M shapes (``chip_smoke.py``'s ``full``
phase: 138,493 x 26,744, 19,733,979 interactions, batch 131,072, Adam,
pipeline v4) for ``N`` epochs (4 by default) under each setting: the
prep overlap off (each epoch's prep before its device work, on all the
native library's threads), then on at each thread count of
``--threads`` (the native library's OpenMP threads; all of them by
default).  ``--wide`` adds the wide engine (``BPR(256)``, ``chip_smoke``'s
``bpr-wide``) overlap off and on.  The settings run in turns, forward
then backward (A, B, C, C, B, A), in one process on one card.  Each fit
prints per epoch ``prep_s`` (host clock), ``device_s`` (CUDA events) and
the epoch's wall (validator probe to probe: the first epoch's holds the
once-per-fit prep), then the fit's wall, its end-to-end int/s and the
mean wall and int/s of the epochs after the first.  The streams, and so
the tables, are the same bits under every setting; the script checks it
through a hash of W and H.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def fit(X, dev, K: int, epochs: int, overlap: bool, threads: int) -> str:
    import cymf_tpu_torch as ct
    from cymf_tpu_torch import native

    native.set_num_threads(threads)
    m = ct.BPR(num_components=K, learning_rate=0.001, optimizer="adam",
               weight_decay=0.01, batch_size=cs.BATCH, device=dev)
    # the trainer's switch for the overlap (on by default)
    m._overlap_prep = overlap
    probe = cs._DeviceProbe(m)
    N = X.count_nonzero()
    t0 = time.perf_counter()
    m.fit(X, num_epochs=epochs, valid_evaluator=probe, verbose=False)
    wall = time.perf_counter() - t0
    walls = probe.walls(t0)
    what = (f"K={K} overlap {'on' if overlap else 'off'}, "
            f"{native.num_threads()} threads")
    for e, st in enumerate(m.epoch_times_):
        cs.phase(what, f"epoch {e}: prep {st['prep_s']:.4f} s, device "
                 f"{st['device_s']:.4f} s, wall {walls[e]:.4f} s")
    h = hashlib.sha256(m.W.tobytes() + m.H.tobytes()).hexdigest()[:16]
    steady = float(np.mean(walls[1:]))
    cs.phase(what, f"fit wall {wall:.4f} s, {N * epochs / wall:.4e} int/s "
             f"end to end; epochs after the first {steady:.4f} s, "
             f"{N / steady:.4e} int/s; tables {h}")
    native.set_num_threads(0)
    return h


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--threads", default="")
    ap.add_argument("--wide", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prep_timing: no CUDA device", file=sys.stderr)
        return 1
    from cymf_tpu_torch import native
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    native.lib()
    cs.phase("host", f"os.cpu_count() {os.cpu_count()}, native OpenMP "
             f"threads {native.num_threads()}, torch intra-op threads "
             f"{torch.get_num_threads()}")
    dev = torch.device("cuda", 0)
    X = cs.bench_matrix()
    threads = [int(t) for t in args.threads.split(",") if t] or [0]
    settings = [(20, False, 0)] + [(20, True, t) for t in threads]
    if args.wide:
        settings += [(cs.WIDE_K, False, 0), (cs.WIDE_K, True, 0)]
    tables = {}
    for K, overlap, t in settings + settings[::-1]:
        np.random.seed(0)
        h = fit(X, dev, K, args.epochs, overlap, t)
        if tables.setdefault(K, h) != h:
            raise AssertionError(f"K={K}: the tables differ between "
                                 "settings")
    print("prep_timing: tables the same bits under every setting",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
