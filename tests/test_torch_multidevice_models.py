"""The port's sharded WMF, ExpoMF, RelMF and GloVe (fused, kfold, packed)
at 2, 3 and 4 ranks, against the JAX package's ``shard_map`` forms and the
port's own single-device fits; the collectives' sizes; cross-mesh resume;
the multi-device dry run.

As in ``test_torch_multidevice.py``, each test starts its ranks as
processes running this file as a script (``python
tests/test_torch_multidevice_models.py <dir> <rank> <world>``): gloo over a
``FileStore`` in the test's directory, one torch thread, the jobs read
from ``case.json``, the results written to ``out<rank>.npz``.  The ranks
import neither JAX nor the JAX package: the JAX references are computed
here, on ``conftest.py``'s virtual CPU devices (``jax.devices()[:n]``), and
reach the ranks as files.  Each group is joined with a timeout; a rank
that fails or hangs fails the test with every rank's stderr.

Every rank counts the calls of the trainers' sharded functions and of
their single-device forms: a fit on a mesh must call the first and never
the second.  While a sharded function runs, the rank also records the
shape of every collective it makes (``MeshContext``'s methods wrapped).

Tolerances are the JAX package's own for 1 against 8 devices
(`tests/test_multichip.py`): tables ``rtol 2e-3, atol 2e-5``; ``mu``
``rtol 2e-3, atol 2e-6``; losses ``rtol 1e-5``; under Adam (RelMF) at
least 99% of the elements within the table tolerance and every element
within ``3 lr``.  RelMF's cells are JAX's threefry draws, handed to the
ranks' ``models.relmf._draw_cells``.  The batch is 96, which 2, 3 and 4
ranks divide and the co-occurrence matrices exceed, so every mesh trains
on the single device's batches.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TABLE_TOL = dict(rtol=2e-3, atol=2e-5)
MU_TOL = dict(rtol=2e-3, atol=2e-6)
BATCH = 96

# the sharded functions each trainer's mesh path must call, and the
# single-device forms it must not
SHARDED = {
    "wmf": ("sharded_wmf_chunk", "sharded_gramian"),
    "expomf": ("sharded_expomf_chunk",),
    "relmf": ("sharded_relmf_epoch",),
    "glove": ("sharded_glove_epoch", "sharded_glove_kfold_epoch",
              "sharded_packed_glove_epoch"),
}
ONE_DEVICE = {
    "wmf": ("wmf_chunk_solve", "wmf_chunk_solve_woodbury"),
    "expomf": ("expomf_chunk",),
    "relmf": ("_relmf_epoch", "packed_relmf_epoch",
              "packed_relmf_epoch_device"),
    "glove": ("_glove_epoch", "packed_glove_epoch"),
}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _instrument(calls: dict, log: list):
    """Count the calls of the functions above in the model modules, and
    record each collective made inside a sharded one."""
    import functools

    from cymf_tpu_torch import models
    from cymf_tpu_torch.parallel import MeshContext

    inside = []
    for mod, names in SHARDED.items():
        module = getattr(models, mod)
        for name in names + ONE_DEVICE[mod]:
            fn = getattr(module, name)

            @functools.wraps(fn)
            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                inside.append(_name)
                try:
                    return _fn(*a, **k)
                finally:
                    inside.pop()
            setattr(module, name, counted)
    for op in ("all_reduce", "all_gather", "reduce_scatter", "broadcast"):
        fn = getattr(MeshContext, op)

        def recorded(self, t, _fn=fn, _op=op):
            if inside:
                log.append((inside[-1], _op, list(t.shape)))
            return _fn(self, t)
        setattr(MeshContext, op, recorded)


def _fit_job(job, rank):
    import warnings

    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import relmf

    X = sparse.load_npz(job["X"])
    if job.get("draws"):
        z = np.load(job["draws"])
        it = iter(zip(z["u"], z["i"]))
        relmf._draw_cells = lambda gen, B, U, I, dev: tuple(
            torch.from_numpy(a).to(dev) for a in next(it))
    if job.get("np_seed") is not None:
        np.random.seed(job["np_seed"] + (rank if job.get("seed_by_rank")
                                         else 0))
    out = {}
    model = getattr(ct, job["model"])(device="cpu", **job["kw"])
    fit = dict(job["fit"], **({} if job["model"] == "GloVe"
                              else {"verbose": False}))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            model.fit(X, **fit)
        except ValueError as e:
            out["error"] = np.array(str(e))
            return out
    out["warn"] = np.array([str(x.message) for x in w] or [""])
    if job["model"] == "GloVe":
        for k in ("W_central", "W_context", "bias", "context_bias"):
            out[k] = getattr(model, k)
        out["loss"] = np.float64(model.last_loss)
        out["packed"] = np.array(model.packed_engine_)
    else:
        out["W"], out["H"] = model.W, model.H
        if job["model"] == "ExpoMF":
            out["mu"] = model.mu
        if getattr(model, "last_loss", None) is not None:
            out["loss"] = np.float64(model.last_loss)
    return out


def _collective_job(job, mesh):
    """Each sharded function called once on synthetic inputs whose tables
    (``TR x K`` each) are much larger than a batch or a chunk; the
    collectives are recorded by ``_instrument``.  Returns the tables'
    element count."""
    from cymf_tpu_torch import models
    from cymf_tpu_torch.ops import packed as pk
    from cymf_tpu_torch.ops.als import AlsChunk, place_mesh_chunks
    from cymf_tpu_torch.ops.glove_epoch import prep_glove_shard_static
    from cymf_tpu_torch.ops.hashset import build_pair_hashset, to_device
    from cymf_tpu_torch.optim import AdaGrad, make_optimizer

    TR, K, B, S, C, P = (job[k] for k in ("TR", "K", "B", "S", "C", "P"))
    n, cpu = mesh.num_devices, torch.device("cpu")
    rng = np.random.default_rng(0)

    def table(width=K, scale=0.1):
        return mesh.put_table(
            rng.normal(size=(TR, width)).astype(np.float32) * scale)

    # RelMF's batch epoch
    W, H = table(), table()
    opt = make_optimizer("adam", 0.01)
    hs = to_device(build_pair_hashset(rng.integers(0, TR, 5000),
                                      rng.integers(0, TR, 5000)), cpu)
    gen = torch.Generator().manual_seed(1)
    models.relmf.sharded_relmf_epoch(
        mesh, W, H, opt.init(W), opt.init(H), hs,
        torch.full((TR, 1), 0.5), gen, optimizer=opt, weight_decay=0.01,
        clip_value=0.1, num_users=TR, num_items=TR, num_steps=S,
        batch_size=B, binary=True, draw=models.relmf._draw_cells)

    # GloVe's batch epochs: central-sorted steps, this rank's slices
    c2 = np.sort(rng.integers(0, TR, (S, B)), axis=1).astype(np.int32)
    x2 = rng.integers(0, TR, (S, B)).astype(np.int32)
    n2 = rng.integers(1, 30, (S, B)).astype(np.float64)
    Bn, p = B // n, mesh.rank

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:, p * Bn:(p + 1) * Bn]))

    ada = AdaGrad(0.05)
    steps = [local(c2), local(x2), local(n2.astype(np.float32))]
    Wc, Wx = table(K + 2), table(K + 2)
    models.glove.sharded_glove_epoch(
        mesh, Wc, Wx, ada.init(Wc), ada.init(Wx), *steps, S * B,
        optimizer=ada, x_max=10.0, alpha=0.75, K=K, num_central=TR)
    Wc, Wx, bc, bx = table(), table(), table(1), table(1)
    models.glove.sharded_glove_kfold_epoch(
        mesh, Wc, Wx, bc, bx, ada.init(Wc), ada.init(Wx),
        torch.ones_like(bc), torch.ones_like(bx), *steps, S * B,
        optimizer=ada, x_max=10.0, alpha=0.75, K=K, num_central=TR,
        num_central_pad=TR)

    # packed GloVe: the rank's row shard of the packed central table
    Kp = K + 2
    rw = pk.packed_rows(TR, Kp, multiple=256 * n)
    rh = pk.logical_rows(TR, multiple=256)
    st = prep_glove_shard_static(c2, x2, n2, TR, K, rw, rh, 256, 256, n,
                                 10.0, 0.75, shard=p)
    Zc = mesh.put_table(np.ones((rw, 128), np.float32) * 0.01)
    Zx = torch.full((rh, 128), 0.01)
    models.glove.sharded_packed_glove_epoch(
        mesh, Zc, Zx, {"accum": torch.ones_like(Zc)},
        {"accum": torch.ones_like(Zx)},
        *(torch.from_numpy(st[i][0]) for i in (0, 1, 2, 3, 4, 6, 7, 8, 5)),
        S * B, lr=0.05, K=K, rw=rw, rh=rh)

    # one WMF and one ExpoMF chunk of C rows
    rows = rng.permutation(TR)[:C].astype(np.int32)
    chunk = place_mesh_chunks([AlsChunk(
        rows, rng.integers(0, TR, (C, P)).astype(np.int32),
        rng.random((C, P)) < 0.7, np.ones((C, P), np.float32))], mesh)[0]
    Y, T = table(), table()
    A0 = models.wmf.sharded_gramian(mesh, Y, 0.01)
    models.wmf.sharded_wmf_chunk(mesh, Y, T, A0, None, chunk, weight=10.0,
                                 solver="cholesky")
    E_src, E_oth = table(scale=0.01), table(scale=0.01)
    models.expomf.sharded_expomf_chunk(
        mesh, E_src, E_oth, E_oth, torch.full((TR // n,), 99.0), T, chunk,
        lam_y=1.0, ridge=0.01 * torch.eye(K), prefactor=0.4,
        solver="cholesky", mu_axis="col", num_real_rows=TR,
        num_real_cols=TR)
    return {"rh": rh}


def _rank_main(tmp: str, rank: int, world: int) -> None:
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    cfg = json.loads((Path(tmp) / "case.json").read_text())
    torch.set_num_threads(1)
    from cymf_tpu_torch.parallel import MeshContext, use_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    out, calls, log = {}, {}, []
    _instrument(calls, log)
    try:
        with use_mesh(MeshContext.create(device="cpu")) as mesh:
            for job in cfg["jobs"]:
                calls.clear()
                log.clear()
                name = job["name"]
                if job["kind"] == "fit":
                    res = _fit_job(job, rank)
                elif job["kind"] == "collectives":
                    res = _collective_job(job, mesh)
                else:
                    from cymf_tpu_torch.parallel.dryrun import \
                        dryrun_multichip
                    res = {"results": json.dumps(dryrun_multichip())}
                res["calls"] = json.dumps(calls)
                res["log"] = json.dumps(log)
                out.update({f"{name}/{k}": np.asarray(v)
                            for k, v in res.items()})
        np.savez(Path(tmp) / f"out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _spawn(tmp: Path, world: int, jobs: list) -> list:
    """Run ``jobs`` on ``world`` ranks; each rank's results, by job name."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "case.json").write_text(json.dumps({"jobs": jobs}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp), str(r), str(world)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    errs = [""] * world
    try:
        for r, p in enumerate(procs):
            try:
                _, errs[r] = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for r, p in enumerate(procs):
            if p in hung:
                errs[r] = p.communicate()[1]
    report = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{errs[r][-3000:]}"
                       for r, p in enumerate(procs))
    assert not hung, f"ranks hung past {TIMEOUT_S} s\n{report}"
    assert all(p.returncode == 0 for p in procs), report
    ranks = []
    for r in range(world):
        with np.load(tmp / f"out{r}.npz") as z:
            got = {}
            for key in z.files:
                job, k = key.split("/", 1)
                v = z[key]
                got.setdefault(job, {})[k] = json.loads(str(v)) \
                    if k in ("calls", "log") else v
            ranks.append(got)
    return ranks


def _synthetic(U, I, seed, density=0.15):
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    return sparse.csr_matrix(SyntheticImplicitDataset(
        num_user=U, num_item=I, rank=4, density=density, seed=seed).train)


def _cooc(V, seed):
    """The JAX multi-device tests' co-occurrence matrices: the upper
    triangle of a sparse count matrix (`tests/test_multichip.py:77-81`)
    and, for the packed engine, a zero-diagonal one (`:428-433`)."""
    rng = np.random.default_rng(seed)
    if V < 60:
        dense = np.triu(rng.integers(0, 20, (V, V))
                        * (rng.random((V, V)) < 0.3))
    else:
        dense = (rng.random((V, V)) < 0.1) * rng.integers(1, 30, (V, V))
        np.fill_diagonal(dense, 0)
    return sparse.csr_matrix(dense.astype(np.float64))


def _nonbinary(X):
    X = X.astype(np.float64)
    X.data[:] = np.random.default_rng(4).integers(1, 5, X.nnz)
    return X


# name -> (model, data, port kwargs, fit kwargs, JAX kwargs where they
# differ); the divisible data at 2 and 4 ranks, the other at 3
MF = dict(num_components=8)
RELMF = dict(num_components=6, learning_rate=0.01, batch_size=BATCH)
GLOVE = dict(num_components=8, batch_size=BATCH, learning_rate=0.05)
JOBS = {
    "wmf": ("WMF", "mf", dict(MF, chunk_size=32), dict(num_epochs=2)),
    "expomf": ("ExpoMF", "mf", dict(MF, chunk_size=32),
               dict(num_epochs=2)),
    "relmf": ("RelMF", "mf", RELMF, dict(num_epochs=2, seed=5)),
    "relmf-nonbinary": ("RelMF", "mf-nb", RELMF, dict(num_epochs=1, seed=5)),
    "glove-fused": ("GloVe", "g", dict(GLOVE, packed="off"),
                    dict(num_epochs=3)),
    "glove-kfold": ("GloVe", "g", dict(GLOVE, packed="off",
                                       bias_mode="kfold"),
                    dict(num_epochs=3)),
    "glove-packed": ("GloVe", "gp", dict(GLOVE, packed="on"),
                     dict(num_epochs=3)),
}
DATA = {2: "even", 4: "even", 3: "odd"}


def _matrices(kind):
    if kind == "even":
        mf = _synthetic(96, 64, 13)
        return {"mf": mf, "mf-nb": _nonbinary(mf), "g": _cooc(28, 4),
                "gp": _cooc(90, 8)}
    mf = _synthetic(101, 67, 5)
    return {"mf": mf, "mf-nb": _nonbinary(mf), "g": _cooc(27, 4),
            "gp": _cooc(91, 8)}


def _relmf_draws(X, seed, epochs, B=BATCH):
    """The JAX batch engine's cells, epoch by epoch: a split of the step
    key ``fold_in(fold_in(PRNGKey(seed), e), s)`` into the user and the
    item draw, the whole batch (its ``shard_map`` form slices it)."""
    import jax
    import jax.numpy as jnp
    U, I = X.shape
    S = max(1, -(-(U * I) // B))
    out = []
    for e in epochs:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            ku, ki = jax.random.split(jax.random.fold_in(key, s))
            out.append(tuple(np.asarray(jax.random.randint(
                k, (B,), 0, n, dtype=jnp.int32)) for k, n in ((ku, U),
                                                              (ki, I))))
    return out


def _save_draws(path, draws):
    np.savez(path, u=np.stack([d[0] for d in draws]),
             i=np.stack([d[1] for d in draws]))
    return str(path)


def _jax_model(model, kw, n):
    import cymf_tpu
    kw = dict(kw)
    if model == "RelMF":
        kw["packed"] = "off"
    return getattr(cymf_tpu, model)(**kw)


def _jax_fit(model, X, kw, fit, n, np_seed=None):
    """The JAX package's fit on ``n`` of the virtual devices (the numpy
    prep stream)."""
    import jax

    from cymf_tpu.parallel import MeshContext, use_mesh
    with use_mesh(MeshContext.create(jax.devices()[:n])):
        if np_seed is not None:
            np.random.seed(np_seed)
        m = _jax_model(model, kw, n)
        if model == "GloVe":
            m.fit(X, **fit)
        else:
            m.fit(X, verbose=False, **fit)
        return _outputs(m, model)


def _outputs(m, model):
    if model == "GloVe":
        return {"W_central": m.W_central, "W_context": m.W_context,
                "bias": m.bias, "context_bias": m.context_bias,
                "loss": m.last_loss}
    out = {"W": np.array(m.W), "H": np.array(m.H)}
    if model == "ExpoMF":
        out["mu"] = np.array(m.mu)
    if getattr(m, "last_loss", None) is not None:
        out["loss"] = m.last_loss
    return out


def _port_fit(model, X, kw, fit, draws=None, monkeypatch=None,
              np_seed=None):
    """The port's single-device fit: RelMF on its batch engine
    (``packed="off"``) with ``draws`` for its cells."""
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import relmf
    kw = dict(kw)
    if model == "RelMF":
        kw["packed"] = "off"
        it = iter(draws)
        monkeypatch.setattr(relmf, "_draw_cells", lambda gen, B, U, I, dev:
                            tuple(torch.from_numpy(np.array(a)) for a in next(it)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if np_seed is not None:
            np.random.seed(np_seed)
        m = getattr(ct, model)(device="cpu", **kw)
        if model == "GloVe":
            m.fit(X, **fit)
        else:
            m.fit(X, verbose=False, **fit)
    finally:
        torch.set_num_threads(n)
    return _outputs(m, model)


def _close(got, want, what, adam=False, lr=0.01, tol=TABLE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not adam:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
        return
    off = ~np.isclose(got, want, **tol)
    assert off.mean() <= 0.01, (what, off.mean())
    assert np.abs(got - want).max() <= 3 * lr, (what,
                                                np.abs(got - want).max())


def _compare(got, want, name, what):
    adam = name.startswith("relmf")
    for k, w in want.items():
        if k == "loss":
            np.testing.assert_allclose(float(got[k]), w, rtol=1e-5,
                                       err_msg=f"{name} loss vs {what}")
        else:
            _close(got[k], w, f"{name} {k} vs {what}", adam,
                   tol=MU_TOL if k == "mu" else TABLE_TOL)


def _expected_calls(name):
    model = name.split("-")[0]
    if model == "glove":
        kind = name.split("-")[1]
        return {"fused": "sharded_glove_epoch",
                "kfold": "sharded_glove_kfold_epoch",
                "packed": "sharded_packed_glove_epoch"}[kind]
    return SHARDED[model]


def _fit_jobs(tmp, mats, names, draws_by_name, fits=None, tag=""):
    jobs = []
    for name in names:
        model, data, kw, fit = JOBS[name]
        X = tmp / f"{data}.npz"
        sparse.save_npz(X, mats[data])
        job = {"kind": "fit", "name": name, "model": model, "X": str(X),
               "kw": kw, "fit": dict(fit, **(fits or {}).get(name, {})),
               "np_seed": 11 if model == "GloVe" else None}
        if name in draws_by_name:
            job["draws"] = _save_draws(tmp / f"draws-{name}{tag}.npz",
                                       draws_by_name[name])
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_fits_match_jax_and_one_device(n, tmp_path, monkeypatch):
    """WMF, ExpoMF (``mu`` too), RelMF (binary, under ``packed="auto"``,
    and non-binary), GloVe fused, kfold and packed, on ``n`` ranks: each
    rank holds the same gathered tables, within tolerance of the JAX
    package's ``n``-device fit and of the port's single-device fit; the
    fits called their sharded functions only.  At 3 ranks no table's
    rows divide evenly (101 x 67, 27 and 91 words)."""
    mats = _matrices(DATA[n])
    names = list(JOBS)
    draws = {name: _relmf_draws(mats[JOBS[name][1]], 5,
                                range(JOBS[name][3]["num_epochs"]))
             for name in names if name.startswith("relmf")}
    ranks = _spawn(tmp_path / "ranks", n, _fit_jobs(tmp_path, mats, names,
                                                    draws))
    for name in names:
        model, data, kw, fit = JOBS[name]
        X = mats[data]
        seed = 11 if model == "GloVe" else None
        want_j = _jax_fit(model, X, kw, fit, n, seed)
        want_1 = _port_fit(model, X, kw, fit, draws.get(name), monkeypatch,
                           seed)
        expect = _expected_calls(name)
        expect = (expect,) if isinstance(expect, str) else expect
        for r, out in enumerate(ranks):
            got = out[name]
            assert set(got["calls"]) == set(expect), (name, r, got["calls"])
            for k in want_j:
                if k != "loss":
                    np.testing.assert_array_equal(got[k], ranks[0][name][k])
        got = ranks[0][name]
        if model == "GloVe":
            assert bool(got["packed"]) == (name == "glove-packed")
        _compare(got, want_j, name, f"JAX on {n} devices")
        _compare(got, want_1, name, "the port on one device")


def test_glove_ranks_seeded_differently(tmp_path):
    """The ranks' ambient numpy states differ (seeded 11 + rank): rank 0's
    init and shuffle reach every rank, and the fit is the single-device
    fit seeded 11, for each engine."""
    mats = _matrices("even")
    names = ["glove-fused", "glove-kfold", "glove-packed"]
    jobs = _fit_jobs(tmp_path, mats, names, {})
    for job in jobs:
        job["seed_by_rank"] = True
    ranks = _spawn(tmp_path / "ranks", 2, jobs)
    for name in names:
        model, data, kw, fit = JOBS[name]
        want = _port_fit(model, mats[data], kw, fit, np_seed=11)
        for out in ranks:
            _compare(out[name], want, name, "one device seeded 11")


def test_mesh_routing_and_warnings(tmp_path):
    """On a mesh ``RelMF(packed="on")`` raises the JAX package's
    ``ValueError``; a batch that the world does not divide is padded with
    its warning, and the fit still runs the sharded epoch."""
    X = _synthetic(40, 30, 3, 0.2)
    sparse.save_npz(tmp_path / "X.npz", X)
    base = {"kind": "fit", "model": "RelMF", "X": str(tmp_path / "X.npz"),
            "fit": dict(num_epochs=1, seed=1)}
    ranks = _spawn(tmp_path / "ranks", 3, [
        dict(base, name="on", kw=dict(num_components=4, packed="on")),
        dict(base, name="pad", kw=dict(num_components=4, batch_size=100))])
    for out in ranks:
        assert "single-device mesh" in str(out["on"]["error"])
        assert any("padded to 102" in str(w) for w in out["pad"]["warn"])
        assert out["pad"]["calls"] == {"sharded_relmf_epoch": 1}
        assert np.isfinite(out["pad"]["W"]).all()


def test_collective_sizes(tmp_path):
    """No collective of the sharded RelMF, GloVe (fused, kfold), WMF or
    ExpoMF step is table-sized: at 20,000-row tables of width 8, each is
    O(batch) (256), O(C K) or O(C K^2) (a chunk of 64 rows, 16 positives
    each), the counterpart of ``tests/test_sharding_hlo.py:286-443``.
    Packed GloVe makes exactly one ``(rh, 128)`` all-reduce a step, and one
    of its loss."""
    TR, K, B, S, C, P = 20_000, 8, 256, 2, 64, 16
    ranks = _spawn(tmp_path / "ranks", 2, [{
        "kind": "collectives", "name": "c", "TR": TR, "K": K, "B": B,
        "S": S, "C": C, "P": P}])
    table = TR * K
    for out in ranks:
        log = out["c"]["log"]
        rh = int(out["c"]["rh"])
        by = {}
        for fn, op, shape in log:
            by.setdefault(fn, []).append((op, shape))
        assert set(by) == {"sharded_relmf_epoch", "sharded_glove_epoch",
                           "sharded_glove_kfold_epoch",
                           "sharded_packed_glove_epoch", "sharded_gramian",
                           "sharded_wmf_chunk", "sharded_expomf_chunk"}
        bounds = {"sharded_relmf_epoch": B * 2 * K,
                  "sharded_glove_epoch": B * 2 * (K + 2),
                  "sharded_glove_kfold_epoch": B * (2 * K + 2),
                  "sharded_gramian": K * K,
                  "sharded_wmf_chunk": C * P * K,
                  "sharded_expomf_chunk": C * K * K + C * P * K}
        for fn, bound in bounds.items():
            for op, shape in by[fn]:
                size = int(np.prod(shape))
                assert size <= bound < table // 8, (fn, op, shape)
        # per step: the rows' reduce-scatter, the gradients' all-gather
        # (and GloVe's indices'), one loss all-reduce an epoch
        assert [op for op, _ in by["sharded_relmf_epoch"]] == \
            ["reduce_scatter", "all_gather"] * S + ["all_reduce"]
        for fn in ("sharded_glove_epoch", "sharded_glove_kfold_epoch"):
            assert [op for op, _ in by[fn]] == \
                ["all_gather", "reduce_scatter", "all_gather"] * S \
                + ["all_reduce"]
        assert by["sharded_packed_glove_epoch"] == \
            [("all_reduce", [rh, 128])] * S + [("all_reduce", [])]
        assert [op for op, _ in by["sharded_wmf_chunk"]] == \
            ["all_gather", "reduce_scatter", "all_gather"]
        assert [op for op, _ in by["sharded_expomf_chunk"]] == \
            ["all_reduce", "all_gather", "reduce_scatter",
             "reduce_scatter", "all_gather"]


RESUME = ["wmf", "expomf", "relmf", "glove-fused", "glove-packed"]


@pytest.mark.parametrize("name", RESUME)
def test_resume_across_meshes(name, tmp_path, monkeypatch):
    """2 ranks write a checkpoint after 2 of 4 epochs that one device
    resumes, and 2 ranks resume a one-device checkpoint and one the JAX
    package wrote on 8 devices; each resumed fit against the uninterrupted
    one-device fit (the JAX-resumed one against JAX's uninterrupted
    8-device fit)."""
    model, data, kw, _ = JOBS[name]
    mats = _matrices("even")
    X = mats[data]
    seed = 11 if model == "GloVe" else None
    fit = dict(seed=5) if model == "RelMF" else {}
    draws = {e: _relmf_draws(X, 5, range(e, e + 2)) for e in (0, 2)} \
        if model == "RelMF" else {0: None, 2: None}
    p1, p2, pj = (str(tmp_path / f"{k}.npz") for k in ("one", "two", "jax"))
    both = (draws[0] or []) + (draws[2] or [])
    want = _port_fit(model, X, kw, dict(fit, num_epochs=4), both or None,
                     monkeypatch, seed)
    _port_fit(model, X, kw, dict(fit, num_epochs=2, checkpoint_path=p1),
              draws[0], monkeypatch, seed)
    _jax_fit(model, X, kw, dict(fit, num_epochs=2, checkpoint_path=pj), 8,
             seed)
    want_j = _jax_fit(model, X, kw, dict(fit, num_epochs=4), 8, seed)
    jobs = []
    for tag, path, epochs, d in (("write", p2, 2, 0), ("one", p1, 4, 2),
                                 ("jax", pj, 4, 2)):
        f = dict(fit, num_epochs=epochs, checkpoint_path=path,
                 resume=tag != "write")
        job = _fit_jobs(tmp_path, mats, [name], {name: draws[d]} if
                        draws[d] else {}, {name: f}, tag)[0]
        job["name"] = tag
        jobs.append(job)
    ranks = _spawn(tmp_path / "ranks", 2, jobs)
    for out in ranks:
        _compare(out["one"], {k: v for k, v in want.items() if k != "loss"},
                 name, "2 ranks resuming one device")
        _compare(out["jax"], {k: v for k, v in want_j.items()
                              if k != "loss"}, name,
                 "2 ranks resuming JAX on 8 devices")
    got = _port_fit(model, X, kw, dict(fit, num_epochs=4, checkpoint_path=p2,
                                       resume=True), draws[2], monkeypatch,
                    seed)
    _compare(got, {k: v for k, v in want.items() if k != "loss"}, name,
             "one device resuming 2 ranks")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, tmp_path):
    """``parallel/dryrun.py::dryrun_multichip`` on ``n`` ranks: every
    trainer on its sharded path, the evaluator and ``recommend``; every
    rank returns the same results."""
    ranks = _spawn(tmp_path / "ranks", n, [{"kind": "dryrun",
                                            "name": "d"}])
    res = [json.loads(str(out["d"]["results"])) for out in ranks]
    assert all(r == res[0] for r in res)
    assert set(res[0]) >= {"bpr-batch", "bpr-packed", "bpr-wide", "relmf",
                           "expomf", "wmf", "glove-packed", "glove-fused",
                           "glove-kfold", "DCG@5"}
    calls = ranks[0]["d"]["calls"]
    for fns in SHARDED.values():
        assert all(calls.get(f) for f in fns), calls
    assert not any(calls.get(f) for fns in ONE_DEVICE.values()
                   for f in fns), calls


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
