"""The port's sharded BPR paths at 2, 3 and 4 ranks, against the JAX
package's ``shard_map`` forms and the port's own single-device paths.

Each test starts its ranks as processes running this file as a script
(``python tests/test_torch_multidevice.py <dir> <rank> <world>``): gloo
over a ``FileStore`` in the test's own directory, one torch thread, the
case read from ``case.json`` and the results written to ``out<rank>.npz``.
The ranks import neither JAX nor the JAX package: the JAX references are
computed here, in the pytest process, on the virtual CPU devices that
``conftest.py`` makes, and reach the ranks as files.  Each group is
joined with a timeout; a rank that fails or hangs fails the test with
every rank's stderr.

Tolerances: losses within ``rtol 1e-5``, tables
within ``rtol 2e-3, atol 2e-5`` (the JAX package's own for 1 against 8
devices), and under Adam at least 99% of the elements within that and
every element within ``3 lr`` (first-touch sign flips under a changed
summation order).  Both packages draw the numpy prep stream
(``CYMF_TPU_PREP=numpy``); the batch engine's negatives are JAX's
threefry draws, handed to the ranks' draw function.
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
TIMEOUT_S = 90
TABLE_TOL = dict(rtol=2e-3, atol=2e-5)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(tmp: str, rank: int, world: int) -> None:
    import collections
    import datetime
    import warnings

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    cfg = json.loads((Path(tmp) / "case.json").read_text())
    os.environ.update(cfg.get("env", {}))
    torch.set_num_threads(1)
    import cymf_tpu_torch as ct
    from cymf_tpu_torch import native
    from cymf_tpu_torch.models import bpr
    from cymf_tpu_torch.parallel import MeshContext, use_mesh

    if os.environ.get("CYMF_TPU_PREP") != "numpy":
        native.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    calls = collections.Counter()
    for name in ("sharded_packed_bpr_epoch", "sharded_wide_bpr_epoch",
                 "sharded_bpr_epoch"):
        def counted(*a, _fn=getattr(bpr, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(bpr, name, counted)
    if cfg.get("draws"):
        it = iter(np.load(cfg["draws"]))
        bpr._draw_negatives = lambda gen, B, I, dev: torch.from_numpy(
            next(it)).to(dev)
    try:
        with use_mesh(MeshContext.create(device="cpu")):
            if cfg["case"] == "fit":
                X = sparse.load_npz(cfg["X"])
                for f, fit in enumerate(cfg["fits"]):
                    with warnings.catch_warnings(record=True) as w:
                        warnings.simplefilter("always")
                        m = ct.BPR(device="cpu", **fit["kw"])
                        m.fit(X, verbose=False, **fit["fit"])
                    out[f"W{f}"], out[f"H{f}"] = m.W, m.H
                    out[f"loss{f}"] = np.float64(m.last_loss)
                    out[f"kernel{f}"] = getattr(m, "packed_kernel_", -1)
                    out[f"warn{f}"] = np.array(
                        [str(x.message) for x in w] or [""])
            elif cfg["case"] == "evaluate":
                z = np.load(cfg["arrays"])
                ev = ct.Evaluator(sparse.load_npz(cfg["X"]),
                                  sparse.load_npz(cfg["X_train"]),
                                  k=[1, 5], num_negatives=cfg["negatives"],
                                  device="cpu")
                res = ev.evaluate(z["W"], z["H"], seed=cfg["seed"])
                out["keys"] = np.array(sorted(res))
                out["values"] = np.array([res[k] for k in sorted(res)])
            else:
                z = np.load(cfg["arrays"])
                out["scores"], out["items"] = ct.recommend(
                    z["W"], z["H"], k=cfg["k"],
                    exclude=sparse.load_npz(cfg["X"]), device="cpu")
        out["calls"] = np.array(json.dumps(calls))
        np.savez(Path(tmp) / f"out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _spawn(tmp: Path, world: int, case: dict) -> list:
    """Run ``case`` on ``world`` ranks; their ``out<rank>.npz`` contents."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "case.json").write_text(json.dumps(case))
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
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


def _close(got, want, lr, adam, what):
    if not adam:
        np.testing.assert_allclose(got, want, err_msg=what, **TABLE_TOL)
        return
    off = ~np.isclose(got, want, **TABLE_TOL)
    assert off.mean() <= 0.01, (what, off.mean())
    assert np.abs(got - want).max() <= 3 * lr, (what,
                                                np.abs(got - want).max())


def _synthetic(U, I, density, seed, rank=6):
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    return sparse.csr_matrix(SyntheticImplicitDataset(
        num_user=U, num_item=I, rank=rank, density=density, seed=seed).train)


def _matrices():
    """The JAX package's multi-device test data
    (`tests/test_multichip.py:14-17`, `:285-306`, `:381-430`)."""
    X300 = sparse.random(300, 150, density=0.1, random_state=3,
                         format="csr")
    X300.data[:] = 1.0
    return {"small": _synthetic(96, 64, 0.15, 13, rank=4),
            "3001": _synthetic(3001, 1203, 0.005, 21),
            "300": X300, "1301": _synthetic(1301, 403, 0.01, 21)}


@pytest.fixture(scope="module")
def mats():
    return _matrices()


@pytest.fixture
def numpy_prep(monkeypatch):
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")


def _jax_fit(X, n, kw, fit):
    import jax

    import cymf_tpu
    from cymf_tpu.parallel import MeshContext, use_mesh
    with use_mesh(MeshContext.create(jax.devices()[:n])):
        m = cymf_tpu.BPR(**kw)
        m.fit(X, verbose=False, **fit)
        return m.W.copy(), m.H.copy(), m.last_loss


def _port_fit(X, kw, fit, draws=None, monkeypatch=None):
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import bpr
    if draws is not None:
        it = iter(draws)
        monkeypatch.setattr(bpr, "_draw_negatives",
                            lambda gen, B, I, dev: torch.from_numpy(next(it)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = ct.BPR(device="cpu", **kw)
        m.fit(X, verbose=False, **fit)
    finally:
        torch.set_num_threads(n)
    return m.W, m.H, m.last_loss


def _batch_draws(X, kw, fit):
    """The JAX batch engine's negatives for this fit, step by step: step
    ``s`` of epoch ``e`` draws from ``fold_in(fold_in(PRNGKey(seed), e),
    s)``, the whole batch (its shard_map form slices it)."""
    import jax
    import jax.numpy as jnp
    N, I = X.nnz, X.shape[1]
    B = min(kw["batch_size"], N)
    S = -(-N // B)
    out = []
    for e in range(fit["num_epochs"]):
        key = jax.random.fold_in(jax.random.PRNGKey(fit["seed"]), e)
        for s in range(S):
            out.append(np.asarray(jax.random.randint(
                jax.random.fold_in(key, s), (B,), 0, I, dtype=jnp.int32)))
    return np.stack(out)


# engine, data, BPR arguments, epochs, seed
FITS = {
    "packed": ("small", dict(num_components=8, learning_rate=0.02,
                             batch_size=128, packed="on"), 3, 3),
    "packed-3001-sgd": ("3001", dict(num_components=12, learning_rate=0.02,
                                     batch_size=2048, packed="on",
                                     optimizer="sgd"), 2, 9),
    "wide-sgd": ("300", dict(num_components=128, learning_rate=0.02,
                             batch_size=1024, packed="on", optimizer="sgd"),
                 2, 3),
    "wide-1301": ("1301", dict(num_components=130, learning_rate=0.02,
                               batch_size=1024, packed="on"), 2, 9),
    "batch": ("small", dict(num_components=8, learning_rate=0.02,
                            batch_size=128, packed="off"), 3, 3),
}
SHARDED = {"packed": "sharded_packed_bpr_epoch",
           "wide": "sharded_wide_bpr_epoch",
           "batch": "sharded_bpr_epoch"}


@pytest.mark.parametrize("name,n", [
    ("packed", 2), ("packed", 4), ("packed-3001-sgd", 2),
    ("packed-3001-sgd", 4), ("wide-sgd", 2), ("wide-1301", 2),
    ("wide-1301", 4), ("batch", 2), ("batch", 4)])
def test_sharded_fit_matches_jax_and_one_device(name, n, mats, tmp_path,
                                                numpy_prep, monkeypatch):
    data, kw, epochs, seed = FITS[name]
    X = mats[data]
    fit = dict(num_epochs=epochs, seed=seed)
    adam = kw.get("optimizer", "adam") == "adam"
    lr = kw["learning_rate"]
    case = {"case": "fit", "X": str(tmp_path / "X.npz"),
            "env": {"CYMF_TPU_PREP": "numpy"},
            "fits": [{"kw": kw, "fit": fit}]}
    sparse.save_npz(tmp_path / "X.npz", X)
    draws = None
    if kw["packed"] == "off":
        draws = _batch_draws(X, kw, fit)
        np.save(tmp_path / "draws.npy", draws)
        case["draws"] = str(tmp_path / "draws.npy")
    ranks = _spawn(tmp_path / "ranks", n, case)
    Wj, Hj, lj = _jax_fit(X, n, kw, fit)
    W1, H1, l1 = _port_fit(X, kw, fit, draws, monkeypatch)
    engine = name.split("-")[0]
    for r, out in enumerate(ranks):
        calls = json.loads(str(out["calls"]))
        assert calls == {SHARDED[engine]: epochs}, (r, calls)
        # every rank holds the whole gathered tables, the same bits
        np.testing.assert_array_equal(out["W0"], ranks[0]["W0"])
        np.testing.assert_array_equal(out["H0"], ranks[0]["H0"])
    W, H, loss = ranks[0]["W0"], ranks[0]["H0"], float(ranks[0]["loss0"])
    assert W.shape == X.shape[:1] + (kw["num_components"],)
    assert H.shape == X.shape[1:] + (kw["num_components"],)
    if engine == "packed":
        assert int(ranks[0]["kernel0"]) == 4
    for want_w, want_h, want_l, what in ((Wj, Hj, lj, "jax"),
                                         (W1, H1, l1, "port 1-device")):
        np.testing.assert_allclose(loss, want_l, rtol=1e-5, err_msg=what)
        _close(W, want_w, lr, adam, f"W vs {what}")
        _close(H, want_h, lr, adam, f"H vs {what}")


def test_mesh_warnings(mats, tmp_path, numpy_prep):
    """``neg_pool`` on a mesh warns "single-chip" and every rank runs the
    one-device pool engine; the batch engine's ``update_mode="sparse"``
    warns and runs the sharded dense epoch, as in the JAX package."""
    X = mats["small"]
    sparse.save_npz(tmp_path / "X.npz", X)
    kw = dict(num_components=8, batch_size=128, packed="on", neg_pool=128)
    sparse_kw = dict(num_components=8, batch_size=128, packed="off",
                     update_mode="sparse")
    fit = dict(num_epochs=1, seed=3)
    ranks = _spawn(tmp_path / "ranks", 2, {
        "case": "fit", "X": str(tmp_path / "X.npz"),
        "env": {"CYMF_TPU_PREP": "numpy"},
        "fits": [{"kw": kw, "fit": fit}, {"kw": sparse_kw, "fit": fit}]})
    W1, H1, _ = _port_fit(X, kw, fit)
    for out in ranks:
        assert any("single-chip" in w for w in out["warn0"]), out["warn0"]
        assert int(out["kernel0"]) == 8
        # every rank runs the one-device pool engine: its exact fit
        np.testing.assert_array_equal(out["W0"], W1)
        np.testing.assert_array_equal(out["H0"], H1)
        assert any("single-device path only" in w for w in out["warn1"])
        assert json.loads(str(out["calls"])) == {"sharded_bpr_epoch": 1}


@pytest.mark.parametrize("name", ["packed-3001-sgd", "wide-1301", "batch"])
def test_resume_across_meshes(name, mats, tmp_path, numpy_prep):
    """2 ranks write a checkpoint mid-fit that one device resumes, and a
    one-device checkpoint resumes on 2 ranks; each against the
    uninterrupted one-device fit.  The packed 2-rank checkpoint also
    resumes in the JAX package on one device."""
    data, kw, _, seed = FITS[name]
    X = mats[data]
    sparse.save_npz(tmp_path / "X.npz", X)
    adam = kw.get("optimizer", "adam") == "adam"
    lr = kw["learning_rate"]
    p2, p1 = str(tmp_path / "ranks.npz"), str(tmp_path / "one.npz")
    W_ref, H_ref, _ = _port_fit(X, kw, dict(num_epochs=4, seed=seed))
    _port_fit(X, kw, dict(num_epochs=2, seed=seed, checkpoint_path=p1))
    ranks = _spawn(tmp_path / "ranks", 2, {
        "case": "fit", "X": str(tmp_path / "X.npz"),
        "env": {"CYMF_TPU_PREP": "numpy"},
        "fits": [{"kw": kw, "fit": dict(num_epochs=2, seed=seed,
                                         checkpoint_path=p2)},
                 {"kw": kw, "fit": dict(num_epochs=4, seed=seed,
                                         checkpoint_path=p1,
                                         resume=True)}]})
    for out in ranks:
        _close(out["W1"], W_ref, lr, adam, "2 ranks resume a 1-device run")
        _close(out["H1"], H_ref, lr, adam, "2 ranks resume a 1-device run")
    W, H, _ = _port_fit(X, kw, dict(num_epochs=4, seed=seed,
                                    checkpoint_path=p2, resume=True))
    _close(W, W_ref, lr, adam, "1 device resumes a 2-rank run")
    _close(H, H_ref, lr, adam, "1 device resumes a 2-rank run")
    if name.startswith("packed"):
        Wj, Hj, _ = _jax_fit(X, 1, kw, dict(num_epochs=4, seed=seed))
        Wr, Hr, _ = _jax_fit(X, 1, kw, dict(num_epochs=4, seed=seed,
                                            checkpoint_path=p2,
                                            resume=True))
        _close(Wr, Wj, lr, adam, "JAX resumes a 2-rank run")
        _close(Hr, Hj, lr, adam, "JAX resumes a 2-rank run")


@pytest.mark.parametrize("U,I,negatives,seed,n", [
    (100, 60, 20, 11, 2), (1003, 517, 30, 2, 4)])
def test_sharded_evaluator_all_ties(U, I, negatives, seed, n, tmp_path):
    """Every score ties (``H = 0``), so the stable top-k ranks the
    positives first and each metric is a function of a user's positive
    count, whatever negatives a rank draws
    (`tests/test_multichip.py:97-127`): the sharded result equals the
    single-device one and the JAX package's."""
    import jax

    import cymf_tpu_torch as ct
    from cymf_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
    from cymf_tpu.parallel import MeshContext, use_mesh
    rng = np.random.default_rng(U)
    X_test = sparse.random(U, I, density=0.05 if U < 1000 else 0.02,
                           random_state=2, format="csr",
                           data_rvs=lambda k: np.ones(k))
    X_train = sparse.random(U, I, density=0.1 if U < 1000 else 0.05,
                            random_state=3, format="csr",
                            data_rvs=lambda k: np.ones(k))
    W, H = rng.normal(size=(U, 8)), np.zeros((I, 8))
    sparse.save_npz(tmp_path / "X.npz", X_test)
    sparse.save_npz(tmp_path / "Xt.npz", X_train)
    np.savez(tmp_path / "WH.npz", W=W, H=H)
    ranks = _spawn(tmp_path / "ranks", n, {
        "case": "evaluate", "X": str(tmp_path / "X.npz"),
        "X_train": str(tmp_path / "Xt.npz"),
        "arrays": str(tmp_path / "WH.npz"), "negatives": negatives,
        "seed": seed})
    one = ct.Evaluator(X_test, X_train, k=[1, 5], num_negatives=negatives,
                       device="cpu").evaluate(W, H, seed=seed)
    with use_mesh(MeshContext.create(jax.devices()[:n])):
        jx = JaxEvaluator(X_test, X_train, k=[1, 5],
                          num_negatives=negatives).evaluate(W, H, seed=seed)
    for out in ranks:
        got = dict(zip(out["keys"].tolist(), out["values"].tolist()))
        assert got.keys() == one.keys() == jx.keys()
        assert any(v > 0 for v in got.values())
        for k in got:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got[k], jx[k], rtol=1e-6, atol=1e-7)


def test_sharded_recommend(tmp_path):
    """37 x 53 with exclusions at 3 ranks (53 items do not split evenly):
    the items equal the single-device ones and the JAX package's
    exactly, on every rank."""
    import jax

    import cymf_tpu
    import cymf_tpu_torch as ct
    from cymf_tpu.parallel import MeshContext, use_mesh
    rng = np.random.default_rng(7)
    W, H = rng.normal(size=(37, 5)), rng.normal(size=(53, 5))
    X = sparse.random(37, 53, density=0.2, random_state=1, format="csr",
                      data_rvs=lambda k: np.ones(k))
    sparse.save_npz(tmp_path / "X.npz", X)
    np.savez(tmp_path / "WH.npz", W=W, H=H)
    ranks = _spawn(tmp_path / "ranks", 3, {
        "case": "recommend", "X": str(tmp_path / "X.npz"),
        "arrays": str(tmp_path / "WH.npz"), "k": 7})
    s1, i1 = ct.recommend(W, H, k=7, exclude=X, device="cpu")
    with use_mesh(MeshContext.create(jax.devices()[:3])):
        sj, ij = cymf_tpu.recommend(W, H, k=7, exclude=X)
    for out in ranks:
        np.testing.assert_array_equal(out["items"], i1)
        np.testing.assert_array_equal(out["items"], ij)
        np.testing.assert_allclose(out["scores"], s1, rtol=1e-6)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
