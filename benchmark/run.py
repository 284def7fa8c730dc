"""Run one cell of the benchmark of ``cymf_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its traffic driver in
``traffic/<driver>.py`` (the cell's ``driver``, else its ``traffic``),
each per-layer metric's reader in ``metrics/<metric>.py``, and the
metrics a cell reports in ``BENCHMARK.json`` at the root of the
checkout. The run makes its inputs from ``--seed``, warms up (set-up),
measures for ``--seconds``, checks what the window produced against the
plain references in ``reference/``, and prints one JSON line last on
standard output: the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``. A traced run measures the same
window, then profiles a further stretch of the same traffic (the traffic
driver's ``traced``): the spans come from the window, the device trace
from the stretch.

Options for calibrating the comparison, which the benchmark's own runs do
not use: ``--calibrate MODE --seeds a,b,...`` makes one answer a seed in
one process, from the program (``program``), the lower-precision control
(``control``) or a planted fault (``unchanged``, ``half``),
and prints each seed's compared numbers; ``--cpu`` runs on the CPU at the
configuration's ``cpu_test`` sizes (the harness's own tests).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the JAX package and what it loads: none may be in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "cymf_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a traffic driver gets: the cell, its configuration, the seed,
    the device, and the mode the answer comes from."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device, cpu: bool,
                 mode: str = "program"):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device, self.mode = device, mode
        # set-up's warm-up; a calibration makes it once a process
        self.warm = True
        self.params = dict(cell["params"], **(cell.get("cpu_test", {})
                                               if cpu else {}))
        self.sizes = dict(cfg, **(cfg.get("cpu_test", {}) if cpu else {}))

    def limit(self, name: str):
        return self.cell["limits"].get(name)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metrics_of(bench: dict, cell: str):
    """``(end_to_end, per_layer)`` entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def check_line(checks):
    """The compared numbers for the result line; a value that is not
    finite (a missing or malformed answer) as its name, which JSON holds."""
    return {name: {"value": value if value is not None
                   and math.isfinite(value) else str(value), "limit": limit}
            for name, value, limit in checks}


def judged(checks) -> bool:
    return all(limit is not None and value is not None
               and not math.isnan(value) and value <= limit
               for _, value, limit in checks)


def run_cell(args, bench, cell, cfg, traffic, device) -> int:
    import torch

    from benchmark import devtrace as tr
    cuda = device.type == "cuda"
    ctx = Context(cell, cfg, args.seed, device, args.cpu)
    state = traffic.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    traffic.window(ctx, state, args.seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if args.trace:
        # after the window, a stretch of the same traffic under the
        # profiler: its cost stays out of the window's spans.  On the CPU
        # (the harness's own tests) the stretch runs unprofiled.
        if cuda:
            tr.attach()
        with tr.window(cuda) as traced:
            traffic.traced(ctx, state)
        if traced.prof is not None:
            summary = tr.summarize(traced.prof)
        traced.prof = None
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the JAX package or JAX "
              "itself is in this process", file=sys.stderr)
        return 3
    traffic.release(ctx, state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = traffic.check(ctx, state)
    correct = judged(checks) and state.failed == 0
    print(f"timing setup {setup_s:.3f} s, window {state.window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    e2e, layer = metrics_of(bench, args.workload)
    metrics = {}
    if args.trace:
        run = traffic.record(ctx, state, summary)
        for m in layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(traffic.end_to_end(ctx, state), setup_s=setup_s,
                      peak_mem_gib=peak / 2**30)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": state.attempted,
           "failed": state.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["span_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = check_line(checks)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def calibrate(args, cell, cfg, traffic, device) -> int:
    """One answer a seed from ``args.calibrate``'s source, each seed's
    compared numbers printed as a JSON line."""
    import torch
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = Context(cell, cfg, seed, device, args.cpu, mode=args.calibrate)
        ctx.warm = k == 0
        state = traffic.setup(ctx)
        if args.calibrate == "program":
            traffic.window(ctx, state, 0)
        else:
            traffic.answer(ctx, state)
        traffic.release(ctx, state)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = traffic.check(ctx, state)
        print(json.dumps({"mode": args.calibrate, "seed": seed,
                          "failed": state.failed,
                          "readings": {n: v for n, v, _ in checks},
                          "correct": judged(checks) and state.failed == 0,
                          "s": time.perf_counter() - t0}), flush=True)
        del state
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--calibrate", choices=("program", "control", "unchanged",
                                           "half"))
    p.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((HERE / "workloads" / f"{args.workload}.json")
                      .read_text())
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    import torch
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    # the measured path runs float32 products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a traffic mix is the cell's parameters; several mixes share a driver
    driver = cell.get("driver", cell["traffic"])
    traffic = load_module(HERE / "traffic" / f"{driver}.py",
                          f"traffic_{driver}")
    try:
        if args.calibrate:
            return calibrate(args, cell, cfg, traffic, device)
        return run_cell(args, bench, cell, cfg, traffic, device)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
