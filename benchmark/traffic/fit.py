"""Traffic of whole public fits, back to back, each on a fresh model.

Parameters (the cell's ``params``): ``epochs`` a fit; ``validation``
(a validation evaluator on a held-out split every epoch, early stopping
off); ``eval_k`` and ``eval_metrics`` for it; ``warmup_every``: the
warm-up fit of set-up trains one epoch on every n-th interaction (the
cell's shapes, little of its host work); ``rate_metric``: the name of
the end-to-end rate the cell reports (default ``train_samples_per_s``).

Every fit of a run starts from the same tables drawn from the seed, and
fit ``n`` shuffles with and draws its negatives from seeds of its own, so
no two fits of a window are the same work twice.  The window holds every
fit started before ``--seconds`` have passed; a traced run then profiles
one more fit (:func:`traced`), so the window's spans carry no profiler
cost.  The check replays one fit of the window, drawn from the seed, in
the plain reference and compares the learned tables (and, with
validation, each epoch's DCG against the reference's DCG of the tables
the evaluator was given).

What differs between models comes from the configuration: ``model`` (the
program's estimator), ``reference`` (the module ``reference/<name>.py``
with ``reference``, ``judge`` and ``work``) and ``fit_seed_arg`` (the
keyword of ``fit`` that takes the fit's seed, if any).
"""

from __future__ import annotations

import importlib
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from benchmark import data, devtrace, roofline
from benchmark.reference import aoa

class _Recorder:
    """The evaluator the window passes to ``fit``: times each
    ``evaluate`` (host clock; it returns host floats) and keeps its inputs
    and answers for the check."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []  # (seconds, DCG, W, H)

    def evaluate(self, W, H, *args, **kw):
        with devtrace.annotate("evaluate"):
            t0 = time.perf_counter()
            out = self.inner.evaluate(W, H, *args, **kw)
            dt = time.perf_counter() - t0
        key = next(iter(out))
        # the trainer hands over fresh host arrays each epoch
        self.calls.append((dt, float(out[key]), np.asarray(W),
                           np.asarray(H)))
        return out


def _model(ctx):
    import cymf_tpu_torch as ct
    cls = getattr(ct, ctx.cfg["model"])
    hyper = dict(ctx.cfg["hyper"], num_components=ctx.sizes["num_components"])
    if "batch_size" in ctx.sizes:
        hyper["batch_size"] = ctx.sizes["batch_size"]
    return cls(**hyper, device=ctx.device)


def _fit_seeds(ctx, n: int):
    return data.sub_seed(ctx.seed, 3, n), data.sub_seed(ctx.seed, 4, n)


def _refmod(ctx):
    """The configuration's reference module, found by its name."""
    name = ctx.cfg.get("reference")
    path = Path(__file__).resolve().parents[1] / "reference" / f"{name}.py"
    if not name or not path.exists():
        raise ValueError(f"configuration {ctx.cfg['name']!r} (model "
                         f"{ctx.cfg['model']!r}) names no reference in "
                         f"benchmark/reference/: {name!r}")
    return importlib.import_module(f"benchmark.reference.{name}")


def _run_fit(ctx, state, n: int, X, evaluator=None, epochs=None):
    """Fit ``n`` of the run: a fresh model from the run's tables."""
    model = _model(ctx)
    model.W, model.H = state.W0, state.H0
    shuffle_seed, fit_seed = _fit_seeds(ctx, n)
    np.random.seed(shuffle_seed)
    arg = ctx.cfg.get("fit_seed_arg")
    kw = {arg: fit_seed} if arg else {}
    model.fit(X, num_epochs=epochs or ctx.params["epochs"], verbose=False,
              valid_evaluator=evaluator, early_stopping=False, **kw)
    return model


def _said(what: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"timing {what} {t - t0:.3f} s", file=sys.stderr)
    return t


def setup(ctx):
    from cymf_tpu_torch.evaluation.evaluator import AoaEvaluator
    _refmod(ctx)  # a configuration without a reference stops here
    s = ctx.sizes
    t = time.perf_counter()
    X = data.interactions(s, ctx.seed)
    valid = None
    if ctx.params.get("validation"):
        X, valid = data.train_valid(X)
    W0, H0 = data.uniform_tables(s["num_user"], s["num_item"],
                                 s["num_components"],
                                 data.sub_seed(ctx.seed, 2), ctx.device)
    state = types.SimpleNamespace(
        X=X, valid=valid, W0=W0.cpu().numpy(), H0=H0.cpu().numpy(),
        evaluator=None, fits=[], traced=[], next_fit=0, attempted=0,
        failed=0, window_s=0.0, fit_work=None)
    t = _said("set-up data and tables", t)
    if valid is not None:
        state.evaluator = AoaEvaluator(
            valid, X, metrics=ctx.params["eval_metrics"],
            k=ctx.params["eval_k"], device=ctx.device)
        # its device state (chunks, hash set) is built once and kept
        state.evaluator.evaluate(state.W0, state.H0)
    if ctx.warm:
        every = ctx.params["warmup_every"]
        coo = X.tocoo()
        keep = slice(None, None, every)
        Xw = type(X)((coo.data[keep], (coo.row[keep], coo.col[keep])),
                     shape=X.shape)
        _run_fit(ctx, state, 1 << 30, Xw.tocsr(), state.evaluator, epochs=1)
    _said("set-up warm-up", t)
    return state


def _one_fit(ctx, state, n: int):
    """Fit ``n`` on the cell's data, its spans kept; None if it failed
    (counted, and not correct)."""
    rec = _Recorder(state.evaluator) \
        if state.evaluator is not None else None
    state.attempted += 1
    with devtrace.annotate("fit"):
        a = time.perf_counter()
        try:
            model = _run_fit(ctx, state, n, state.X, rec)
        except Exception:
            import traceback
            traceback.print_exc()
            state.failed += 1
            return None
        b = time.perf_counter()
    print(f"timing fit {n} {b - a:.3f} s", file=sys.stderr)
    times = model.epoch_times_
    E = ctx.params["epochs"]
    return dict(
        n=n, wall=b - a, W=model.W, H=model.H, epochs=E,
        # early stopping is off: a fit trains every interaction E times
        samples=E * state.X.nnz,
        device_s=[t["device_s"] if isinstance(t, dict) else t
                  for t in times],
        prep_s=[t["prep_s"] for t in times
                if isinstance(t, dict) and "prep_s" in t],
        build_s=getattr(model, "chunks_", {}).get("build_s"),
        evals=rec.calls if rec else [])


def window(ctx, state, seconds: float) -> None:
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        fit = _one_fit(ctx, state, n)
        if fit is not None:
            state.fits.append(fit)
        n += 1
    state.window_s = time.perf_counter() - t0
    state.next_fit = n


def traced(ctx, state) -> None:
    """The traced run's profiled stretch, after the window: one more
    fit, its own work."""
    fit = _one_fit(ctx, state, state.next_fit)
    state.traced = [fit] if fit is not None else []


def answer(ctx, state) -> None:
    """The fit's answer from the lower-precision control or a planted
    fault, in the program's place (``--calibrate``): ``control`` (the
    reference in bfloat16 for BPR, TF32 products for WMF, its DCG from
    bfloat16 scores), ``half`` (half of each step's samples, or of each
    block's rows, left out) or ``unchanged`` (the tables as they came)."""
    mode, E = ctx.mode, ctx.params["epochs"]
    aoa_ref = None
    if state.valid is not None:
        aoa_ref = aoa.AoaReference(state.valid, state.X,
                                   k=ctx.params["eval_k"], device=ctx.device)
    dt = torch.bfloat16 if mode == "control" else torch.float32
    W, H, evals = state.W0, state.H0, []
    ref = None
    if mode in ("control", "half"):
        ref = _reference(ctx, state, 0, control=mode == "control",
                         keep=0.5 if mode == "half" else 1.0)
    for e in range(E):
        if ref is not None:
            ref.epoch(e)
            W, H = (t.float().cpu().numpy() for t in ref.tables())
        if aoa_ref is not None:
            evals.append((0.0, aoa_ref.dcg(W, H, dt), W, H))
    state.attempted = 1
    state.fits.append(dict(n=0, W=W, H=H, evals=evals))


def release(ctx, state) -> None:
    state.evaluator = None


def _reference(ctx, state, n: int, control: bool = False, keep=1.0):
    shuffle_seed, fit_seed = _fit_seeds(ctx, n)
    return _refmod(ctx).reference(
        state.X, state.W0, state.H0, ctx.cfg, ctx.sizes,
        shuffle_seed=shuffle_seed, fit_seed=fit_seed, device=ctx.device,
        control=control, keep=keep)


def _rel(a, b) -> float:
    b = torch.as_tensor(b).double()
    d = torch.as_tensor(a).to(b.device).double() - b
    return float(d.norm() / b.norm().clamp_min(1e-300))


def check(ctx, state):
    if not state.fits:
        return [(name, float("inf"), ctx.limit(name))
                for name in ctx.cell["limits"]]
    pick = int(np.random.default_rng(data.sub_seed(ctx.seed, 9))
               .integers(len(state.fits)))
    fit = state.fits[pick]
    aoa_ref = None
    t = time.perf_counter()
    if ctx.params.get("validation"):
        aoa_ref = aoa.AoaReference(state.valid, state.X,
                                   k=ctx.params["eval_k"], device=ctx.device)
        t = _said("check evaluator reference set-up", t)
    ref = _reference(ctx, state, fit["n"])
    t = _said("check reference set-up", t)
    for e in range(ctx.params["epochs"]):
        ref.epoch(e)
    Wr, Hr = ref.tables()
    t = _said("check replay", t)
    mod = _refmod(ctx)
    state.fit_work = mod.work(ref, state.X, ctx.sizes, ctx.params["epochs"])
    out = [("W_rel", _rel(fit["W"], Wr), ctx.limit("W_rel")),
           ("H_rel", _rel(fit["H"], Hr), ctx.limit("H_rel"))]
    out += [(name, value, ctx.limit(name)) for name, value in
            mod.judge(ref, fit["W"], fit["H"], state.X, ctx.cfg).items()]
    if aoa_ref is not None:
        gap = 0.0 if len(fit["evals"]) == ctx.params["epochs"] \
            else float("inf")
        for _, got, W, H in fit["evals"]:
            want = aoa_ref.dcg(W, H)
            gap = max(gap, abs(got - want) / max(abs(want), 1e-12))
        out.append(("dcg_rel", gap, ctx.limit("dcg_rel")))
    _said("check comparison", t)
    return out


def end_to_end(ctx, state) -> dict:
    """Samples trained in the window over its wall, under the name the
    cell's ``rate_metric`` gives (``train_samples_per_s`` by default)."""
    name = ctx.params.get("rate_metric", "train_samples_per_s")
    return {name: sum(f["samples"] for f in state.fits) / state.window_s}


def _least_s(ctx, state, fits):
    """The least time the card could take for the model work of
    ``fits``: each fit's work as the check's replay counted it."""
    if state.fit_work is None or not fits:
        return None
    s = ctx.sizes
    total = roofline.least_s(*state.fit_work) * len(fits)
    if state.valid is not None:
        # an evaluation scores each user's test positives and 100
        # negatives: 2 K operations a candidate, both tables read once
        K = s["num_components"]
        cand = state.valid.nnz + 100 * s["num_user"]
        per = roofline.least_s(2.0 * cand * K,
                               (s["num_user"] + s["num_item"]) * K * 4
                               + cand * 8)
        total += per * sum(len(f["evals"]) for f in fits)
    return total


def record(ctx, state, summary):
    """What the per-layer metrics read: the window's fits (spans, and the
    least time of their model work over the window's wall), the profiled
    stretch's fits with its device trace and the least time of its
    work."""
    return types.SimpleNamespace(
        kind="train", model=ctx.cfg["model"], fits=state.fits,
        window_s=state.window_s, least_s=_least_s(ctx, state, state.fits),
        trace=summary, traced=state.traced,
        least_traced_s=_least_s(ctx, state, state.traced))
