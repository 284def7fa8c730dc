"""Traffic of batch recommendation: a closed loop with one client.

Each call is ``cymf_tpu_torch.recommend(W, H, k, exclude=X)`` for every
user of the catalog, its answer brought to the host.  ``pairs`` table
pairs are drawn from the seed in set-up (standard normal, the tables'
width), and call ``n`` scores pair ``n % pairs``.  The window holds every
call started before ``--seconds`` have passed; a traced run then
profiles :data:`TRACED_CALLS` more (:func:`traced`), so the window
carries no profiler cost.  The check compares the answers of ``checked`` calls of the
window drawn from the seed, and of its last call, with the plain
reference.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark import data, devtrace, roofline
from benchmark.reference import topk

# calls the traced run profiles after its window (~3 s at full size)
TRACED_CALLS = 32

def setup(ctx):
    from cymf_tpu_torch import recommend
    s, p = ctx.sizes, ctx.params
    X = data.interactions(s, ctx.seed)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(data.sub_seed(ctx.seed, 5))
    U, I, K = s["num_user"], s["num_item"], s["num_components"]
    pairs = []
    for _ in range(p["pairs"]):
        W = torch.randn((U, K), generator=gen, device=ctx.device)
        H = torch.randn((I, K), generator=gen, device=ctx.device)
        pairs.append((W.cpu().numpy(), H.cpu().numpy()))
    rng = np.random.default_rng(data.sub_seed(ctx.seed, 6))
    keep = set(rng.choice(p["first_calls"], p["checked"], replace=False)
               .tolist())
    state = types.SimpleNamespace(X=X, pairs=pairs, keep=keep, answers={},
                                  lat=[], traced_lat=[], attempted=0,
                                  failed=0, window_s=0.0)
    if ctx.warm:
        recommend(*pairs[0], k=p["k"], exclude=X, device=ctx.device)
    return state


def _call(ctx, state, n: int):
    """Call ``n``: its answer, or None if it failed (counted, and not
    correct); its latency appended to ``lat``."""
    from cymf_tpu_torch import recommend
    state.attempted += 1
    with devtrace.annotate("recommend"):
        a = time.perf_counter()
        try:
            out = recommend(*state.pairs[n % len(state.pairs)],
                            k=ctx.params["k"], exclude=state.X,
                            device=ctx.device)
        except Exception:
            import traceback
            traceback.print_exc()
            state.failed += 1
            return None
        return out, time.perf_counter() - a


def window(ctx, state, seconds: float) -> None:
    t0 = time.perf_counter()
    n = 0
    last = None
    while n == 0 or time.perf_counter() - t0 < seconds:
        got = _call(ctx, state, n)
        if got is not None:
            out, dt = got
            state.lat.append(dt)
            if n in state.keep:
                state.answers[n] = out
            last = (n, out)
        n += 1
    state.window_s = time.perf_counter() - t0
    state.next_call = n
    if last is not None:
        state.answers[last[0]] = last[1]


def traced(ctx, state) -> None:
    """The traced run's profiled stretch, after the window:
    :data:`TRACED_CALLS` more calls."""
    n = state.next_call
    for n in range(n, n + TRACED_CALLS):
        got = _call(ctx, state, n)
        if got is not None:
            state.traced_lat.append(got[1])


def answer(ctx, state) -> None:
    """The control's answer in the program's place (``--calibrate``):
    the reference's top-k from TF32 products; ``unchanged``: every row
    the lowest item ids; ``half``: the first half of the users' answers
    only, the rest copied from them."""
    W, H = (torch.as_tensor(t).to(ctx.device) for t in state.pairs[0])
    k = ctx.params["k"]
    if ctx.mode == "unchanged":
        items = np.tile(np.arange(k, dtype=np.int32), (W.shape[0], 1))
        out = (np.zeros(items.shape, np.float32), items)
    else:
        s, i = topk.topk(W, H, state.X, k, precision="tf32"
                         if ctx.mode == "control" else "float32")
        if ctx.mode == "half":
            h = len(s) // 2
            s[h:], i[h:] = s[:len(s) - h], i[:len(i) - h]
        out = (s, i)
    state.attempted = 1
    state.answers = {0: out}


def release(ctx, state) -> None:
    pass


def check(ctx, state):
    names = ("rank_gap", "score_err")
    if not state.answers:
        return [(n, float("inf"), ctx.limit(n)) for n in names]
    worst = dict.fromkeys(names, 0.0)
    P, k = len(state.pairs), ctx.params["k"]
    for n, (scores, items) in sorted(state.answers.items()):
        W, H = (torch.as_tensor(t).to(ctx.device) for t in state.pairs[n % P])
        got = topk.judge(W, H, state.X, k, scores, items)
        for name in names:
            worst[name] = max(worst[name], got[name])
    return [(n, worst[n], ctx.limit(n)) for n in names]


def end_to_end(ctx, state) -> dict:
    lat = np.asarray(state.lat)
    return {"recommend_users_per_s":
            len(lat) * ctx.sizes["num_user"] / state.window_s,
            "recommend_call_ms_p95": float(np.percentile(lat, 95)) * 1e3}


def record(ctx, state, summary):
    """What the per-layer metrics read: the window's calls (the least
    time of their work over the window's wall), the profiled stretch's
    device trace and the least time of its calls' work."""
    s = ctx.sizes
    per = roofline.least_s(*roofline.recommend_call(
        s["num_user"], s["num_item"], s["num_components"], ctx.params["k"],
        state.X.nnz))
    return types.SimpleNamespace(
        kind="serve", calls=len(state.lat), lat=state.lat,
        window_s=state.window_s, least_s=per * len(state.lat),
        trace=summary, least_traced_s=per * len(state.traced_lat))
