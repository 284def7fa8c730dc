"""Times and checks the sharded trainers on the card, apart from the rest of
``chip_smoke.py``.

    python3 mesh_timing.py                # one NCCL rank a card, then two
                                          # gloo ranks on card 0
    python3 mesh_timing.py --nccl-only    # the NCCL ranks alone (on four
                                          # cards: the 4-card checks)
    python3 mesh_timing.py --profile      # torch.profiler splits at one rank

The NCCL ranks run ``chip_smoke.py``'s ``mesh_models_direct`` (each
sharded function of WMF, ExpoMF, RelMF and GloVe at full width against
the one-device fit's first epoch) and, on more than one card, the sharded
BPR v4 epoch and 20 batch-engine steps (``mesh_packed``, ``mesh_batch``);
the gloo ranks run ``mesh_gloo_models`` (the public fits and
``dryrun_multichip``).  ``--profile`` splits, by ``torch.profiler``, the
sharded GloVe fused epoch and 40 sharded RelMF steps at one NCCL rank
beside the one-device epochs on the same inputs, into
``chiprun_out/mesh_profile.txt``.  Every line names the card and its power
limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUN_DIR = ROOT / "build" / "mesh_timing"
RANK_TIMEOUT_S = 400


def rank_main(r: int, world: int, backend: str, d: Path) -> None:
    """One rank: joins the group through a file store in ``d`` and runs its
    checks."""
    import torch.distributed as dist

    from cymf_tpu_torch.parallel import MeshContext, use_mesh

    dev = torch.device("cuda", r % torch.cuda.device_count()) \
        if backend == "nccl" else torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = (d / "smi.txt").read_text().strip()
    dist.init_process_group(backend, init_method=f"file://{d}/store_{backend}",
                            rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = MeshContext.create(device=dev)
        tag = f"mesh {backend} {r}/{world}"
        t0 = time.perf_counter()
        mesh.barrier()
        cs.phase(tag, f"{smi}; first collective {time.perf_counter() - t0:.3f}"
                 " s")
        with use_mesh(mesh):
            if backend == "nccl":
                out = cs.mesh_models_direct(mesh, tag, smi)
                if world > 1:
                    from cymf_tpu_torch.ops.packed_epoch import \
                        make_reject_filter
                    X = cs.bench_matrix()
                    coo = X.tocoo()
                    keys = np.sort(coo.row.astype(np.int64) * cs.I + coo.col)
                    cs.mesh_packed(X, mesh, tag, smi, keys,
                                   make_reject_filter(keys, cs.U, cs.I))
                    cs.mesh_batch(X, mesh, tag, smi, steps=20)
            else:
                cs.phase(tag, f"gloo collectives on CUDA tensors: "
                         f"{cs.mesh_probe(mesh)}")
                out = cs.mesh_gloo_models(mesh, tag, smi)
        cs.phase(tag, f"launches {out}")
    finally:
        dist.destroy_process_group()


def profile_split(fn, title: str, out) -> None:
    """``fn()`` once to warm up, then once under ``torch.profiler``: its
    wall and the top ops by device and by host time, with their totals."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = p.key_averages()
    # the tables end in the host's and the card's self time totals
    out.write(f"=== {title}: wall {wall * 1e3:.2f} ms\n")
    out.write(ka.table(sort_by="self_device_time_total", row_limit=18) + "\n")
    out.write(ka.table(sort_by="self_cpu_time_total", row_limit=18) + "\n")
    out.flush()
    print(f"[profile] {title}: wall {wall * 1e3:.2f} ms", flush=True)


def profile_main(d: Path, smi: str) -> None:
    """The ``--profile`` splits at one NCCL rank (this process)."""
    import torch.distributed as dist

    import cymf_tpu_torch as ct
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    from cymf_tpu_torch.models import glove, relmf
    from cymf_tpu_torch.models.base import padded_rows
    from cymf_tpu_torch.models.sgd import epoch_generator
    from cymf_tpu_torch.parallel import MeshContext, use_mesh
    from cymf_tpu_torch.parallel.shard_step import (sharded_glove_epoch,
                                                    sharded_relmf_epoch)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{d}/store_prof",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    mesh = MeshContext.create(device=dev)
    mesh.barrier()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    out = open(ROOT / "chiprun_out" / "mesh_profile.txt", "w")
    out.write(smi + "\n")
    try:
        G = cs.glove_matrix()
        np.random.seed(0)
        m = ct.GloVe(cs.GLOVE_K, batch_size=cs.BATCH, packed="off",
                     update_mode="dense", device=dev)
        with cs.world_of_one(dev):
            got = cs.record_calls(glove, {"_glove_epoch": 1},
                                  lambda: m.fit(G, num_epochs=1))
        args, kw = got["_glove_epoch"][0]
        steps, N, opt = args[8:11], args[11], kw["optimizer"]

        def one_glove():
            Wc, Wx = args[0].clone(), args[1].clone()
            glove._glove_epoch(Wc, Wx, args[2], args[3], opt.init(Wc),
                               opt.init(Wx), args[6], args[7], *steps, N,
                               **kw)

        def sharded_glove():
            Wc, Wx = (mesh.put_table(padded_rows(T, T.shape[0]))
                      for T in args[:2])
            sharded_glove_epoch(
                mesh, Wc, Wx, opt.init(Wc), opt.init(Wx), *steps, N,
                optimizer=opt, x_max=kw["x_max"], alpha=kw["alpha"],
                K=kw["num_components"], num_central=G.shape[0])

        X = SyntheticImplicitDataset(num_user=cs.ML1M_U, num_item=cs.ML1M_I,
                                     rank=8, density=0.04, seed=0).train
        r = ct.RelMF(num_components=cs.RELMF_K, batch_size=cs.BATCH,
                     packed="off", update_mode="dense", device=dev)
        with cs.world_of_one(dev):
            got = cs.record_calls(relmf, {"_relmf_epoch": 1},
                                  lambda: r.fit(X, num_epochs=1,
                                                seed=cs.MESH_SEED))
        (W, H, _, _, labels, props, _), rkw = got["_relmf_epoch"][0]
        ropt, steps40 = rkw["optimizer"], 40

        def one_relmf():
            W1, H1 = W.clone(), H.clone()
            relmf._relmf_epoch(W1, H1, ropt.init(W1), ropt.init(H1), labels,
                               props, epoch_generator(cs.MESH_SEED, 0, dev),
                               **dict(rkw, num_steps=steps40))

        def sharded_relmf():
            W1, H1 = mesh.put_table(W), mesh.put_table(H)
            sharded_relmf_epoch(
                mesh, W1, H1, ropt.init(W1), ropt.init(H1), labels, props,
                epoch_generator(cs.MESH_SEED, 0, dev), optimizer=ropt,
                weight_decay=rkw["weight_decay"],
                clip_value=rkw["clip_value"], num_users=cs.ML1M_U,
                num_items=cs.ML1M_I, num_steps=steps40,
                batch_size=rkw["batch_size"], binary=rkw["binary_labels"],
                draw=relmf._draw_cells)

        with use_mesh(mesh):
            profile_split(one_glove, "GloVe fused, one-device epoch", out)
            profile_split(sharded_glove, "GloVe fused, sharded epoch (1 NCCL "
                          "rank)", out)
            profile_split(one_relmf, "RelMF 40 steps, one-device", out)
            profile_split(sharded_relmf, "RelMF 40 steps, sharded (1 NCCL "
                          "rank)", out)
    finally:
        out.close()
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_timing: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  Path(sys.argv[5]))
        return 0
    from cymf_tpu_torch import native
    from cymf_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.build(verbose=False)
    _kernels.lib()
    native.build()
    native.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{smi}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    for f in RUN_DIR.glob("*"):
        f.unlink()
    (RUN_DIR / "smi.txt").write_text(smi)
    if "--profile" in sys.argv[1:]:
        profile_main(RUN_DIR, smi)
        return 0
    groups = [(torch.cuda.device_count(), "nccl")]
    if "--nccl-only" not in sys.argv[1:]:
        groups.append((2, "gloo"))
    failed = False
    for world, backend in groups:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                   str(world), backend, str(RUN_DIR)])
                 for r in range(world)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        failed |= any(rcs)
        print(f"{backend}, {world} ranks: return codes {rcs}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
