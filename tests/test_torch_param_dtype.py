"""The parameter-dtype switch (``config.set_param_dtype``) in the port,
against the JAX package under the same switch.

Every test that sets the switch does it through the ``param_dtype``
fixture, which sets both packages and restores float32 in its teardown,
even when the test fails (a leaked bfloat16 switch would change every
later test of the worker).

Engines that honour the switch (the batch engines of BPR, RelMF and GloVe,
WMF, ExpoMF), one epoch from the same inputs (the batch engines' draws are
the JAX package's threefry draws, fed to the port's one draw function as
``tests/test_torch_batch_engine.py`` feeds them): the port's tables are
float32 arrays whose every value is bfloat16-representable (numpy has no
bfloat16; the JAX package returns ``ml_dtypes`` arrays of the same values)
and at least 99% of their elements are within two bfloat16 ulps of JAX's
(``rtol 2**-7``), the losses within ``rtol 2**-7``.  The measured spread is
smaller: on this file's data every table of these fits is equal to JAX's
to the bit but WMF's at K=128 (99.9% of H's elements within two ulps,
99.2% equal) and WMF's and ExpoMF's H at K=8 (99.9% equal, the rest one
float32 rounding of a solve apart, then one bfloat16 rounding).  The port
rounds as XLA does on the CPU: each op in bfloat16, a Python constant
rounded to bfloat16 where it meets a table (``config.scalar``), a scatter
adding duplicates one by one in index order, the last op under a row sum
and the sum in float32, the ALS products and solves in float32
(``preferred_element_type``).  WMF's Woodbury route (K=128, small pads)
inverts ``A0`` explicitly and its float32 solutions differ at the 1e-4
level between the packages; bfloat16 turns that into one-ulp flips of 26%
of W's elements, which the second half sweep's ill-conditioned systems
amplify, so that route is held by its unit test on the same bfloat16
inputs (float32 tolerances) rather than by a whole fit.

A 10-epoch quickstart of each honouring trainer reaches test DCG@5 within
0.02 of JAX's bfloat16 fit, both scored by the port's evaluator on the
same negatives.  The engines that ignore the switch (packed BPR v4-v8,
wide BPR, device-prep BPR, packed RelMF under either prep, packed GloVe
and the sequential engines) give float32 tables equal to the bit to their
float32 fits.  The evaluator and ``recommend`` score in float32 from the
bfloat16 tables as JAX's do; checkpoints hold bfloat16 leaves as ``V2``
entries with JAX's bytes and do not resume, in either package.
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
ULP2 = 2.0 ** -7          # two bfloat16 ulps, relative
MESH_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the ranks of the mesh test (this file run as a script; no JAX)
# ---------------------------------------------------------------------------

def _rank_main(tmp: str, rank: int, world: int) -> None:
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import cymf_tpu_torch as ct
    from cymf_tpu_torch.models import bpr
    from cymf_tpu_torch.parallel import MeshContext, use_mesh

    ct.config.set_param_dtype("bfloat16")
    X = sparse.load_npz(f"{tmp}/X.npz")
    with np.load(f"{tmp}/draws.npz") as z:
        draws = iter(z["j"])
    bpr._draw_negatives = lambda gen, B, I, dev: torch.from_numpy(
        next(draws))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    out = {}
    try:
        with use_mesh(MeshContext.create(device="cpu")):
            m = ct.BPR(device="cpu", **json.loads(
                (Path(tmp) / "bpr.json").read_text()))
            m.fit(X, num_epochs=1, verbose=False, seed=5)
            out.update(bpr_W=m.W, bpr_H=m.H, bpr_loss=m.last_loss)
            m = ct.WMF(num_components=8, chunk_size=32, device="cpu")
            m.fit(X, num_epochs=1, verbose=False)
            out.update(wmf_W=m.W, wmf_H=m.H)
        np.savez(f"{tmp}/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests (JAX on conftest.py's virtual CPU devices)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cymf_tpu  # noqa: E402
import cymf_tpu_torch as ct  # noqa: E402
from cymf_tpu.parallel import MeshContext, use_mesh  # noqa: E402
from cymf_tpu_torch.dataset import SyntheticImplicitDataset  # noqa: E402
from cymf_tpu_torch.models import bpr as tbpr  # noqa: E402
from cymf_tpu_torch.models import relmf as trelmf  # noqa: E402


def _switch(dtype):
    """Both packages' param dtype ``dtype`` until the generator is closed
    (or an exception is thrown into it); float32 after, whatever
    happened."""
    cymf_tpu.config.set_param_dtype(jnp.dtype(str(dtype).split(".")[-1]))
    ct.config.set_param_dtype(dtype)
    try:
        yield
    finally:
        cymf_tpu.config.set_param_dtype(jnp.float32)
        ct.config.set_param_dtype(torch.float32)


@pytest.fixture
def param_dtype():
    """bfloat16 in both packages for the test, float32 restored after."""
    yield from _switch(torch.bfloat16)


@pytest.fixture(autouse=True)
def _one_torch_thread_one_device(monkeypatch):
    """One torch thread a test (the suite runs in parallel workers), the
    JAX side on one device (``conftest.py`` fakes 8) and on the numpy
    prep stream, the ALS routing variables unset."""
    monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    for v in ("CYMF_TPU_ALS_CHOL", "CYMF_TPU_ALS_CHOL_BLOCK",
              "CYMF_TPU_ALS_WOODBURY", "CYMF_TPU_PACKED_KERNEL",
              "CYMF_TPU_BPR_PREP", "CYMF_TPU_RELMF_PREP"):
        monkeypatch.delenv(v, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_mesh(MeshContext.create(jax.devices()[:1])):
        yield monkeypatch
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return SyntheticImplicitDataset(num_user=200, num_item=100, rank=5,
                                    density=0.08, seed=11)


@pytest.fixture(scope="module")
def cooc():
    rng = np.random.default_rng(0)
    X = sparse.random(80, 80, density=0.2, random_state=1, format="csr")
    X.data = rng.integers(1, 30, X.nnz).astype(np.float64)
    return X


def _f32(a):
    return np.asarray(a, np.float32)


def _bf16_close(got, want, what, frac=0.99):
    """``got`` a float32 array of bfloat16 values; at least ``frac`` of
    its elements within two bfloat16 ulps of ``want``'s."""
    got = np.asarray(got)
    assert got.dtype == np.float32, (what, got.dtype)
    assert got.shape == np.shape(want), what
    assert not (got.view(np.uint32) & 0xFFFF).any(), \
        f"{what}: values that bfloat16 cannot hold"
    ok = np.isclose(got, _f32(want), rtol=ULP2, atol=0)
    assert ok.mean() >= frac, (what, ok.mean())


def _bpr_draws(seed, epochs, S, B, I):
    """The JAX batch engine's negatives, step by step."""
    out = []
    for e in range(epochs):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            out.append(np.asarray(jax.random.randint(
                jax.random.fold_in(key, s), (B,), 0, I, dtype=jnp.int32)))
    return out


def _relmf_draws(seed, epochs, S, B, U, I):
    """The JAX batch engine's cells: the step key split into the user and
    the item draw."""
    out = []
    for e in range(epochs):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), e)
        for s in range(S):
            ku, ki = jax.random.split(jax.random.fold_in(key, s))
            out.append(tuple(np.asarray(jax.random.randint(
                k, (B,), 0, n, dtype=jnp.int32)) for k, n in ((ku, U),
                                                              (ki, I))))
    return out


def _feed(monkeypatch, module, name, draws):
    it = iter(draws)

    def draw(gen, B, *args):
        d = next(it)
        return tuple(torch.from_numpy(a) for a in d) \
            if isinstance(d, tuple) else torch.from_numpy(d)

    monkeypatch.setattr(module, name, draw)


def _nonbinary(X):
    X = sparse.csr_matrix(X).astype(np.float64)
    X.data[:] = np.random.default_rng(4).integers(1, 5, X.nnz)
    return X


# name -> (trainer, data, kwargs, fit kwargs); the batch engines with
# ``packed="off"``
HONOUR = {
    "bpr-sgd": ("BPR", "mf", dict(optimizer="sgd", learning_rate=0.05,
                                  batch_size=256, packed="off"),
                dict(seed=5)),
    "bpr-adagrad": ("BPR", "mf", dict(optimizer="adagrad",
                                      learning_rate=0.05, batch_size=256,
                                      packed="off"), dict(seed=5)),
    "bpr-adam": ("BPR", "mf", dict(learning_rate=0.01, batch_size=256,
                                   packed="off"), dict(seed=5)),
    "bpr-adam-sparse": ("BPR", "mf", dict(learning_rate=0.01,
                                          batch_size=256, packed="off",
                                          update_mode="sparse"),
                        dict(seed=5)),
    "relmf": ("RelMF", "mf", dict(learning_rate=0.01, batch_size=1024,
                                  packed="off"), dict(seed=9)),
    "relmf-nonbinary": ("RelMF", "mf-nb", dict(learning_rate=0.01,
                                               batch_size=1024,
                                               packed="off"), dict(seed=9)),
    "glove-fused": ("GloVe", "cooc", dict(batch_size=512, packed="off"),
                    {}),
    "glove-kfold": ("GloVe", "cooc", dict(batch_size=512, packed="off",
                                          bias_mode="kfold"), {}),
    "wmf-k8": ("WMF", "mf", {}, {}),
    "wmf-k128": ("WMF", "x128", dict(num_components=128), {}),
    "expomf": ("ExpoMF", "mf", {}, {}),
}


# WMF at K=128 on the standard route (the Woodbury one: the unit test)
HONOUR_ENV = {"wmf-k128": {"CYMF_TPU_ALS_WOODBURY": "off"}}


def _fit_both(name, X, monkeypatch, epochs):
    """One engine's fit in each package under the current switch, the
    port's draws the JAX fit's."""
    model, _, kw, fit = HONOUR[name]
    for k, v in HONOUR_ENV.get(name, {}).items():
        monkeypatch.setenv(k, v)
    kw = dict(dict(num_components=8), **kw)
    U, I = X.shape
    if model == "BPR":
        B = kw["batch_size"]
        _feed(monkeypatch, tbpr, "_draw_negatives",
              _bpr_draws(fit["seed"], epochs, -(-X.nnz // B), B, I))
    elif model == "RelMF":
        B = kw["batch_size"]
        _feed(monkeypatch, trelmf, "_draw_cells",
              _relmf_draws(fit["seed"], epochs, -(-(U * I) // B), B, U, I))
    if model == "GloVe":
        np.random.seed(3)
        mj = cymf_tpu.GloVe(**kw)
        mj.fit(X, num_epochs=epochs, verbose=False)
        np.random.seed(3)
        mt = ct.GloVe(device="cpu", **kw)
        mt.fit(X, num_epochs=epochs, verbose=False)
        return mj, mt
    mj = getattr(cymf_tpu, model)(**kw)
    mj.fit(X, num_epochs=epochs, verbose=False, **fit)
    mt = getattr(ct, model)(device="cpu", **kw)
    mt.fit(X, num_epochs=epochs, verbose=False, **fit)
    return mj, mt


# -- the switch ------------------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    ("float16", torch.float16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16)])
def test_set_param_dtype_takes_dtypes_and_names(name, want):
    gen = _switch(name)
    next(gen)
    try:
        assert ct.config.param_dtype() is want
    finally:
        gen.close()
    assert ct.config.param_dtype() is torch.float32


@pytest.mark.parametrize("bad", ["float64", "int8", torch.float64,
                                 torch.int32, np.float32])
def test_set_param_dtype_rejects_others(bad):
    with pytest.raises(ValueError):
        ct.config.set_param_dtype(bad)
    assert ct.config.param_dtype() is torch.float32


def test_config_names_and_scalar_rounding():
    assert ct.config.index_dtype is torch.int32
    assert ct.config.param_dtype() is torch.float32
    bf = torch.bfloat16
    for x in (0.9, 0.999, 0.1, 1e-8, 0.01, 3.7e9):
        assert ct.config.scalar(x, bf) == float(jnp.asarray(x, jnp.bfloat16))
        assert ct.config.scalar(x, torch.float32) == x


def test_switch_fixture_restores_float32_on_failure():
    """The fixture's body: bfloat16 in both packages inside, float32 in
    both after an exception thrown into it."""
    gen = _switch(torch.bfloat16)
    next(gen)
    assert ct.config.param_dtype() is torch.bfloat16
    assert cymf_tpu.config.param_dtype() == jnp.bfloat16
    with pytest.raises(RuntimeError, match="in the test"):
        gen.throw(RuntimeError("in the test"))
    assert ct.config.param_dtype() is torch.float32
    assert cymf_tpu.config.param_dtype() == jnp.float32


# -- the engines that honour it ------------------------------------------

@pytest.mark.parametrize("name", list(HONOUR))
def test_honouring_engine_one_epoch_matches_jax(name, data, cooc,
                                                param_dtype,
                                                _one_torch_thread_one_device):
    kind = HONOUR[name][1]
    X = cooc if kind == "cooc" else _nonbinary(data.train) \
        if kind == "mf-nb" else sparse.random(
            300, 200, density=0.05, random_state=0, format="csr",
            data_rvs=np.ones) if kind == "x128" \
        else sparse.csr_matrix(data.train)
    mj, mt = _fit_both(name, X, _one_torch_thread_one_device, epochs=1)
    if HONOUR[name][0] == "GloVe":
        # the tables are float64 in both packages (bfloat16 values)
        for k in ("W_central", "W_context", "bias", "context_bias"):
            got = getattr(mt, k)
            assert got.dtype == np.float64
            _bf16_close(got.astype(np.float32), getattr(mj, k), k)
    else:
        assert mj.W.dtype == jnp.bfloat16
        _bf16_close(mt.W, mj.W, "W")
        _bf16_close(mt.H, mj.H, "H")
        if HONOUR[name][0] == "ExpoMF":
            _bf16_close(mt.mu, mj.mu, "mu")
    if getattr(mj, "last_loss", None) is not None:
        np.testing.assert_allclose(mt.last_loss, mj.last_loss, rtol=ULP2)


def test_woodbury_core_bf16_rows_match_jax(param_dtype):
    """The Woodbury solve (WMF at K >= 128, small pads) on the same
    bfloat16 rows and float32 ``A0^-1``: ``b`` in bfloat16, the products in
    float32, the solutions float32 and within float32 tolerances."""
    from cymf_tpu.ops.als import woodbury_core as jwb
    from cymf_tpu_torch.ops.als import woodbury_core
    rng = np.random.default_rng(0)
    C, P, K = 16, 8, 128
    Y = rng.uniform(-0.1, 0.1, (C, P, K)).astype(np.float32)
    valid = rng.random((C, P)) < 0.7
    sub = np.asarray(jnp.asarray(Y * valid[..., None], jnp.bfloat16),
                     np.float32)
    A0 = np.einsum("ipk,ipl->kl", sub, sub) + 0.05 * np.eye(K)
    A0i = np.linalg.inv(A0).astype(np.float32)
    want = np.asarray(jwb(jnp.asarray(sub, jnp.bfloat16), jnp.asarray(A0i),
                          jnp.asarray(valid), jnp.asarray(10.0, jnp.bfloat16),
                          "cholesky_xla"))
    got = woodbury_core(torch.from_numpy(sub).to(torch.bfloat16),
                        torch.from_numpy(A0i), torch.from_numpy(valid), 10.0,
                        "cholesky_xla")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("model", ["BPR", "RelMF", "WMF", "ExpoMF"])
def test_quickstart_learns_as_jax_does(model, param_dtype,
                                       _one_torch_thread_one_device):
    """10 epochs of the quickstart under bfloat16: test DCG@5 within 0.02
    of JAX's bfloat16 fit (both scored by the port's evaluator on the same
    negatives) and at least 0.1 over the untrained tables."""
    d = SyntheticImplicitDataset(num_user=600, num_item=300, rank=6,
                                 density=0.08, seed=7)
    X = sparse.csr_matrix(d.train)
    kw = dict(num_components=20)
    fit = {}
    if model in ("BPR", "RelMF"):
        kw.update(learning_rate=0.01, packed="off")
        fit = dict(seed=5)
    U, I = X.shape
    mp = _one_torch_thread_one_device
    if model == "BPR":
        _feed(mp, tbpr, "_draw_negatives",
              _bpr_draws(5, 10, -(-X.nnz // 1024), 1024, I))
    elif model == "RelMF":
        _feed(mp, trelmf, "_draw_cells",
              _relmf_draws(5, 10, -(-(U * I) // 8192), 8192, U, I))
    mj = getattr(cymf_tpu, model)(**kw)
    mj.fit(X, num_epochs=10, verbose=False, **fit)
    mt = getattr(ct, model)(device="cpu", **kw)
    mt.fit(X, num_epochs=10, verbose=False, **fit)
    ev = ct.AoaEvaluator(d.test, d.train, metrics=["DCG"], k=5, device="cpu")
    fresh = getattr(ct, model)(device="cpu", **kw)
    fresh._ensure_tables(U, I)        # the fit's seeded initial tables
    untrained = ev.evaluate(fresh.W, fresh.H)["DCG@5"]
    got = ev.evaluate(mt.W, mt.H)["DCG@5"]
    want = ev.evaluate(_f32(mj.W), _f32(mj.H))["DCG@5"]
    assert abs(got - want) <= 0.02, (got, want)
    assert got >= untrained + 0.1, (got, untrained)


# -- the engines that ignore it --------------------------------------------

IGNORE = {
    "bpr-v4": ("BPR", dict(packed="on"), {"CYMF_TPU_PACKED_KERNEL": "4"}),
    "bpr-auto": ("BPR", {}, {}),
    "bpr-v7": ("BPR", dict(packed="on"), {"CYMF_TPU_PACKED_KERNEL": "7"}),
    "bpr-pool": ("BPR", dict(packed="on", neg_pool=128), {}),
    "bpr-wide": ("BPR", dict(packed="on", num_components=128), {}),
    "bpr-device-prep": ("BPR", dict(packed="on"),
                        {"CYMF_TPU_BPR_PREP": "device"}),
    "bpr-pallas": ("BPR", dict(engine="pallas"), {}),
    "relmf-device-prep": ("RelMF", dict(packed="on"), {}),
    "relmf-host-prep": ("RelMF", dict(packed="on"),
                        {"CYMF_TPU_RELMF_PREP": "host"}),
    "relmf-pallas": ("RelMF", dict(engine="pallas"), {}),
    "glove-packed": ("GloVe", dict(packed="on"), {}),
    "glove-pallas": ("GloVe", dict(engine="pallas"), {}),
}


@pytest.mark.parametrize("name", list(IGNORE))
def test_ignoring_engine_keeps_float32_bits(name, data, cooc,
                                            _one_torch_thread_one_device):
    model, kw, env = IGNORE[name]
    for k, v in env.items():
        _one_torch_thread_one_device.setenv(k, v)
    kw = dict(dict(num_components=8), **kw)

    def fit():
        m = getattr(ct, model)(device="cpu", **kw)
        if model == "GloVe":
            np.random.seed(3)
            m.fit(cooc, num_epochs=1)
            return m.W_central, m.W_context, m.bias, m.context_bias
        m.fit(data.train, num_epochs=1, verbose=False)
        return m.W, m.H

    want = fit()
    gen = _switch(torch.bfloat16)
    next(gen)
    try:
        got = fit()
    finally:
        gen.close()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.dtype in (np.float32, np.float64)
        np.testing.assert_array_equal(g, w)


# -- evaluation ------------------------------------------------------------

def _eval_data():
    rng = np.random.default_rng(3)
    U, I = 120, 90
    dense = rng.random((U, I)) < 0.08
    test = sparse.csr_matrix(dense & (rng.random((U, I)) < 0.3), dtype=float)
    train = sparse.csr_matrix(dense & ~test.toarray().astype(bool),
                              dtype=float)
    return test, train


@pytest.mark.parametrize("unbiased,ties", [(False, False), (True, False),
                                           (False, True)])
def test_evaluator_scores_bf16_tables_as_jax(unbiased, ties, param_dtype):
    """The chunk scorer on JAX's negatives, from bfloat16 tables: equal to
    JAX's sums within ``rtol 2**-7`` (the metrics are summed in
    bfloat16); with ``H = 0`` every score ties and the positives, listed
    first, win in both."""
    from cymf_tpu.evaluation import evaluator as jev
    from cymf_tpu.ops import hashset as jhs
    from cymf_tpu_torch.evaluation import evaluator as tev
    test, train = _eval_data()
    U, I = test.shape
    rng = np.random.default_rng(4)
    W = rng.normal(size=(U, 8))
    H = np.zeros((I, 8)) if ties else rng.normal(size=(I, 8))
    te = tev.Evaluator(test, train, k=[1, 3, 5], num_negatives=30,
                       unbiased=unbiased, device="cpu")
    ks, names = (1, 3, 5), ("DCG", "Recall", "MAP")
    up = te.user_positives.tocoo()
    hs = jhs.build_pair_hashset(up.row, up.col)
    props = te.propensity_scores
    Wb, Hb = (torch.as_tensor(a, dtype=torch.bfloat16) for a in (W, H))
    pb = torch.as_tensor(props, dtype=torch.bfloat16)
    total = 0.0
    for ci, (uids, pos, val) in enumerate(te._user_chunks):
        key = jax.random.fold_in(jax.random.PRNGKey(7), ci)
        want = np.asarray(jev._chunk_metric_sums(
            jnp.asarray(W, jnp.bfloat16), jnp.asarray(H, jnp.bfloat16),
            jnp.asarray(uids), jnp.asarray(pos), jnp.asarray(val), hs,
            jnp.asarray(props, jnp.bfloat16), key, num_negatives=30, ks=ks,
            metric_names=names, unbiased=unbiased), np.float32)
        neg, nvalid = jev.draw_negatives(jnp.asarray(uids), hs, key, I, 30,
                                         dtype=jnp.int32)
        got = tev._chunk_metric_sums(
            Wb, Hb, torch.from_numpy(uids), torch.from_numpy(pos),
            torch.from_numpy(val), torch.from_numpy(np.array(neg)),
            torch.from_numpy(np.array(nvalid)), pb, ks=ks,
            metric_names=names, unbiased=unbiased)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ULP2,
                                   atol=1e-6)
        total += want.sum()
    assert total > 0


@pytest.mark.parametrize("ties", [False, True])
def test_recommend_bf16_matches_jax(ties, param_dtype):
    """``recommend`` from float64 tables under bfloat16: JAX's items
    (ties by ascending item id, common in bfloat16) and float32 scores
    within float32 round-off of JAX's."""
    rng = np.random.default_rng(5)
    W = rng.normal(size=(50, 8))
    H = rng.normal(size=(40, 8))
    if ties:
        H = np.round(H) * 0.5
        H[::3] = H[1]
    excl = sparse.random(50, 40, density=0.1, random_state=2, format="csr")
    sj, ij = cymf_tpu.recommend(W, H, k=7, exclude=excl)
    st, it = ct.recommend(W, H, k=7, exclude=excl, device="cpu")
    assert st.dtype == np.float32 and it.dtype == np.int32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, np.asarray(sj, np.float32), rtol=1e-6)
    assert (st.view(np.uint32) & 0xFFFF).any()  # float32 sums, not bf16


# -- checkpoints -----------------------------------------------------------

def test_checkpoint_v2_entries_equal_jax_bytes(tmp_path, param_dtype):
    from cymf_tpu.utils import checkpoint as jck
    from cymf_tpu_torch.utils import checkpoint as tck
    rng = np.random.default_rng(0)
    W, m = rng.normal(size=(30, 8)), rng.normal(size=(30, 8)) * 1e-3
    jck.save_checkpoint(str(tmp_path / "j.npz"), {
        "W": jnp.asarray(W, jnp.bfloat16),
        "ow": {"m": jnp.asarray(m, jnp.bfloat16)}}, 3)
    tck.save_checkpoint(str(tmp_path / "t.npz"), {
        "W": torch.as_tensor(W, dtype=torch.bfloat16),
        "ow": {"m": torch.as_tensor(m, dtype=torch.bfloat16)}}, 3)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in ("W", "ow/m"):
            assert zj[k].dtype == zt[k].dtype == np.dtype("V2")
            assert zj[k].tobytes() == zt[k].tobytes()
        assert int(zj["__epoch__"]) == int(zt["__epoch__"]) == 3
    for f in ("j.npz", "t.npz"):
        with pytest.raises(ValueError):
            tck.load_checkpoint(str(tmp_path / f), {
                "W": torch.zeros(30, 8, dtype=torch.bfloat16),
                "ow": {"m": torch.zeros(30, 8, dtype=torch.bfloat16)}})


RESUME = {
    "bpr": ("BPR", dict(packed="off", batch_size=256)),
    "relmf": ("RelMF", dict(packed="off", batch_size=1024)),
    "wmf": ("WMF", {}),
    "expomf": ("ExpoMF", {}),
    "glove": ("GloVe", dict(packed="off", batch_size=512)),
}


@pytest.mark.parametrize("writer,name", [
    ("port", n) for n in RESUME] + [("jax", n) for n in ("bpr", "relmf",
                                                        "wmf")])
def test_bf16_checkpoint_does_not_resume(writer, name, data, cooc, tmp_path,
                                         param_dtype):
    """A checkpoint written under bfloat16 (by either package) holds
    ``V2`` tables, and resuming it raises ``ValueError`` in the port, as
    in the JAX package; under float32 nothing changes."""
    model, kw = RESUME[name]
    kw = dict(num_components=8, **kw)
    X = cooc if model == "GloVe" else data.train
    path = str(tmp_path / "ck.npz")
    pkg = ct if writer == "port" else cymf_tpu
    extra = {} if writer == "jax" else dict(device="cpu")
    m = getattr(pkg, model)(**kw, **extra)
    fit = dict(num_epochs=1, verbose=False, checkpoint_path=path)
    m.fit(X, **fit)
    with np.load(path) as z:
        assert any(z[k].dtype == np.dtype("V2") for k in z.files)
    with pytest.raises(ValueError):
        getattr(ct, model)(device="cpu", **kw).fit(
            X, **dict(fit, num_epochs=2, resume=True))
    if writer == "port" and name == "bpr":
        with pytest.raises(ValueError):
            getattr(cymf_tpu, model)(**kw).fit(
                X, **dict(fit, num_epochs=2, resume=True))


def test_float32_checkpoint_round_trip_stays_exact(data, tmp_path):
    path = str(tmp_path / "f32.npz")
    m = ct.BPR(num_components=8, packed="off", batch_size=256, device="cpu")
    m.fit(data.train, num_epochs=1, verbose=False, checkpoint_path=path)
    with np.load(path) as z:
        assert z["W"].dtype == np.float32
        np.testing.assert_array_equal(z["W"], m.W)
    r = ct.BPR(num_components=8, packed="off", batch_size=256, device="cpu")
    r.fit(data.train, num_epochs=1, verbose=False, checkpoint_path=path,
          resume=True)
    np.testing.assert_array_equal(r.W, m.W)
    np.testing.assert_array_equal(r.H, m.H)


# -- #9, convert -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_chol_inv_takes_reduced_precision_input(dtype):
    """#9's wrapper casts a bfloat16 or float16 ``A`` to float32, as the
    Pallas wrapper does; its plain path against JAX's kernel in interpret
    mode on the same rounded ``A``."""
    from cymf_tpu.ops.chol_kernel import chol_inv_batched as jax_chol_inv
    from cymf_tpu_torch.ops import _kernels
    from cymf_tpu_torch.ops.chol_kernel import chol_inv_batched
    rng = np.random.default_rng(1)
    Xr = rng.standard_normal((8, 64, 8)).astype(np.float32)
    A = torch.from_numpy(np.einsum("cki,cli->ckl", Xr, Xr) / 8
                         + np.eye(64, dtype=np.float32)).to(dtype)
    jd = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float16
    Lj, _ = jax_chol_inv(jnp.asarray(A.float().numpy(), jd), block=64,
                         interpret=True)
    _kernels.reset_launches()
    L, Linv = chol_inv_batched(A, 64)
    assert not _kernels.launches
    assert L.dtype == Linv.dtype == torch.float32
    Lj = np.asarray(Lj)
    assert np.abs(L.numpy() - Lj).max() <= 1e-4 * np.abs(Lj).max()
    assert np.abs(Linv.numpy() @ Lj - np.eye(64)).max() <= 1e-3


def test_convert_keeps_bf16_bits(param_dtype):
    import ml_dtypes

    from cymf_tpu_torch.convert import batch_state_from_jax
    rng = np.random.default_rng(2)
    W = rng.normal(size=(10, 4)).astype(ml_dtypes.bfloat16)
    m = (rng.normal(size=(10, 4)) * 1e-3).astype(ml_dtypes.bfloat16)
    Wt, Ht, ow, _ = batch_state_from_jax(W, W.view("V2"), {"m": m}, {},
                                         "cpu")
    for t, a in ((Wt, W), (Ht, W), (ow["m"], m)):
        assert t.dtype == torch.bfloat16
        assert (t.view(torch.int16).numpy() == a.view(np.int16)).all()
    ct.config.set_param_dtype(torch.float32)
    Wt = batch_state_from_jax(W, W, {}, {}, "cpu")[0]
    assert Wt.dtype == torch.float32
    np.testing.assert_array_equal(Wt.numpy(), W.astype(np.float32))
    # a float32 array stays float32 under bfloat16 (the fused engines')
    ct.config.set_param_dtype(torch.bfloat16)
    assert batch_state_from_jax(W.astype(np.float32), W, {}, {},
                                "cpu")[0].dtype == torch.float32


# -- the mesh --------------------------------------------------------------

def test_mesh_bf16_matches_jax_two_devices(data, tmp_path, param_dtype):
    """BPR's batch engine and WMF on a 2-rank gloo group under bfloat16,
    against the JAX package's 2-device bfloat16 fits (BPR's draws JAX's):
    bfloat16 tables within the two-ulp tolerance, the same on both
    ranks."""
    X = sparse.csr_matrix(data.train)
    kw = dict(num_components=8, learning_rate=0.01, batch_size=256,
              packed="off")
    with use_mesh(MeshContext.create(jax.devices()[:2])):
        bj = cymf_tpu.BPR(**kw)
        bj.fit(X, num_epochs=1, verbose=False, seed=5)
        wj = cymf_tpu.WMF(num_components=8, chunk_size=32)
        wj.fit(X, num_epochs=1, verbose=False)
    sparse.save_npz(tmp_path / "X.npz", X)
    np.savez(tmp_path / "draws.npz", j=np.stack(_bpr_draws(
        5, 1, -(-X.nnz // 256), 256, X.shape[1])))
    (tmp_path / "bpr.json").write_text(json.dumps(kw))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_path), str(r), "2"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    report = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{e[-3000:]}"
                       for r, (p, e) in enumerate(zip(procs, errs)))
    assert all(p.returncode == 0 for p in procs), report
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    got = outs[0]
    _bf16_close(got["bpr_W"], bj.W, "BPR W")
    _bf16_close(got["bpr_H"], bj.H, "BPR H")
    np.testing.assert_allclose(got["bpr_loss"], bj.last_loss, rtol=ULP2)
    _bf16_close(got["wmf_W"], wj.W, "WMF W")
    _bf16_close(got["wmf_H"], wj.H, "WMF H")
