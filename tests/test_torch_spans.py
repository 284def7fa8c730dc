"""The port's span log (``cymf_tpu_torch.utils.profiling``): nesting,
paths and self time, counters, a worker thread's spans, errors, the
profiler's host ranges, the log's bound, and the spans a BPR fit, a WMF
fit, an ExpoMF fit, an evaluation and a ``recommend`` call leave in it."""

import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from scipy import sparse

import cymf_tpu_torch as ct
from cymf_tpu_torch.utils import profiling as P


def last_root(name):
    return [r for r in P.spans() if r.name == name][-1]


class HostCopies:
    """The bytes handed from the host to the device while it is installed,
    seen at torch's own entry points and not through ``profiling.upload``:
    a tensor made from host data (``from_numpy``, ``as_tensor``, ``tensor``
    of an array or a number), or indexed out of a marked one, is marked,
    and a marked tensor's ``.to(<device>)`` counts its bytes once (on the
    CPU the result is the same tensor); a constructor given ``device=``
    counts its result."""

    def __init__(self, monkeypatch):
        self.bytes = 0
        self._host = {}   # id -> weakref of a marked tensor
        self._lock = threading.Lock()
        to, getitem = torch.Tensor.to, torch.Tensor.__getitem__

        def made(fn):
            def inner(data, *args, **kwargs):
                t = fn(data, *args, **kwargs)
                if kwargs.get("device") is not None:
                    self._add(t.nbytes)
                elif not torch.is_tensor(data):
                    self._host[id(t)] = weakref.ref(t)
                return t
            return inner

        def moved(t, *args, **kwargs):
            out = to(t, *args, **kwargs)
            if self._marked(t) and (
                    kwargs.get("device") is not None
                    or any(isinstance(a, (torch.device, str)) for a in args)):
                del self._host[id(t)]
                self._add(t.nbytes)
            return out

        def indexed(t, key):
            out = getitem(t, key)
            if self._marked(t):
                self._host[id(out)] = weakref.ref(out)
            return out

        for name in ("from_numpy", "as_tensor", "tensor"):
            monkeypatch.setattr(torch, name, made(getattr(torch, name)))
        monkeypatch.setattr(torch.Tensor, "to", moved)
        monkeypatch.setattr(torch.Tensor, "__getitem__", indexed)

    def _marked(self, t):
        ref = self._host.get(id(t))
        return ref is not None and ref() is t

    def _add(self, n):
        with self._lock:
            self.bytes += n


def test_nesting_paths_and_self_time():
    with P.span("t.root"):
        with P.span("a"):
            time.sleep(0.02)
            with P.span("b"):
                time.sleep(0.03)
        with P.span("a"):
            pass
    r = P.spans()[-1]
    assert r.name == "t.root" and not r.profiled and not r.error
    assert set(r.paths) == {"a", "a/b"}
    a, b = r.paths["a"], r.paths["a/b"]
    assert a.n == 2 and b.n == 1
    assert b.s >= 0.03 and a.s >= 0.05
    assert a.self_s == pytest.approx(a.s - b.s, abs=1e-6)
    assert r.self_s == pytest.approx(r.seconds - a.s, abs=1e-6)
    assert r.seconds >= a.s


def test_counters_roll_up_to_the_root():
    with P.span("t.counts", h2d_bytes=5):
        with P.span("up"):
            P.count("h2d_bytes", 100)
            with P.span("inner"):
                P.count("h2d_bytes", 20)
                P.count("samples", 7)
        P.count("samples", 1)
    r = P.spans()[-1]
    assert r.paths["up/inner"].counts == {"h2d_bytes": 20, "samples": 7}
    assert r.paths["up"].counts == {"h2d_bytes": 120, "samples": 7}
    assert r.counts == {"h2d_bytes": 125, "samples": 8}
    P.count("h2d_bytes", 1)  # no span open: nothing to count into


def test_worker_span_joins_the_given_root():
    with P.span("t.worker") as root:
        def work():
            with P.span("w.prep", parent=root):
                time.sleep(0.05)
                P.count("h2d_bytes", 3)

        with P.span("wait"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    r = P.spans()[-1]
    assert set(r.paths) == {"wait", "w.prep"}
    assert r.paths["w.prep"].s >= 0.05
    # the worker's time is not taken from the launching thread's spans
    assert r.paths["wait"].self_s == pytest.approx(r.paths["wait"].s)
    assert r.paths["wait"].self_s >= 0.05
    assert r.counts == {"h2d_bytes": 3}


def test_many_workers_lose_no_span():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.span("t.stress") as root:
            def work():
                for _ in range(200):
                    with P.span("w", parent=root):
                        P.count("samples", 1)
                    with P.span("local"):
                        P.count("samples", 1)

            ts = [threading.Thread(target=work) for _ in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    r = P.spans()[-1]
    assert r.paths["w"].n == 3200 and r.counts["samples"] == 3200
    # the workers' own roots
    assert sum(x.name == "local" for x in P.spans()) >= 1024 - 1


def test_error_is_recorded_and_raised():
    with pytest.raises(ValueError):
        with P.span("t.fails"):
            with P.span("inner"):
                raise ValueError("boom")
    r = P.spans()[-1]
    assert r.name == "t.fails" and r.error and r.paths["inner"].n == 1
    with P.span("t.fine"):
        pass
    assert not P.spans()[-1].error


def test_profiled_span_is_a_host_range():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("t.profiled"):
            with P.span("t.child"):
                torch.ones(16).sum()
    r = last_root("t.profiled")
    assert r.profiled and r.paths["t.child"].n == 1
    names = {e.name for e in prof.events()}
    assert {"t.profiled", "t.child"} <= names


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with P.span("t.plain"):
        with P.annotate("t.inner"):
            pass
    assert P.annotate is P.span
    assert not P.spans()[-1].profiled


def test_log_keeps_the_last_roots():
    for i in range(P.LOG_ROOTS + 10):
        with P.span("t.bound", i=i):
            pass
    log = P.spans()
    assert len(log) == P.LOG_ROOTS
    assert log[-1].counts == {"i": P.LOG_ROOTS + 9}
    assert log[0].counts == {"i": 10}


def _interactions(U=300, I=211, nnz=6000, seed=0):
    rng = np.random.default_rng(seed)
    X = sparse.coo_matrix((np.ones(nnz), (rng.integers(0, U, nnz),
                                          rng.integers(0, I, nnz))),
                          shape=(U, I)).tocsr()
    X.data[:] = 1.0
    return X


def test_bpr_fit_spans(monkeypatch):
    """A small fit on the packed engine, as the benchmark's CPU run
    takes it: one ``bpr.fit`` root with the once-per-fit stages, one
    ``epoch`` an epoch, and every byte handed to the device counted."""
    X = _interactions()
    m = ct.BPR(num_components=20, learning_rate=0.001, weight_decay=0.01,
               batch_size=2048, device="cpu")
    copies = HostCopies(monkeypatch)
    m.fit(X, num_epochs=3, verbose=False, seed=7)
    monkeypatch.undo()
    assert m.engine_ == "packed"
    r = last_root("bpr.fit")
    assert not r.error and not r.profiled
    for name in ("bpr.shuffle", "bpr.batches", "bpr.prep_static",
                 "bpr.reject_filter", "bpr.upload"):
        assert r.paths[name].n == 1, name
    assert r.paths["epoch"].n == 3
    for name in ("epoch.prep_wait", "epoch.run", "epoch.run/epoch.upload",
                 "epoch.publish"):
        assert r.paths[f"epoch/{name}"].n == 3, name
    assert r.paths["epoch.prep"].n == 3
    assert r.paths["tables.fetch"].n == 2
    assert r.counts["h2d_bytes"] == copies.bytes > 0
    assert r.counts["h2d_bytes"] == (
        r.paths["bpr.upload"].counts["h2d_bytes"]
        + r.paths["epoch/epoch.run/epoch.upload"].counts["h2d_bytes"])
    assert r.counts["samples"] == 3 * X.nnz
    assert [set(t) for t in m.epoch_times_] == [{"prep_s", "device_s"}] * 3
    assert sum(t["prep_s"] for t in m.epoch_times_) == pytest.approx(
        r.paths["epoch.prep"].s)


@pytest.mark.parametrize("prep", ["native", "numpy"])
def test_bpr_static_prep_counts_native_steps(monkeypatch, prep):
    """``bpr.batches`` and ``bpr.prep_static`` count the steps the native
    library sorted, each step once; none under ``CYMF_TPU_PREP=numpy``,
    and ``static_prep_`` says which ran."""
    if prep == "numpy":
        monkeypatch.setenv("CYMF_TPU_PREP", "numpy")
    else:
        monkeypatch.delenv("CYMF_TPU_PREP", raising=False)
    X = _interactions()
    m = ct.BPR(num_components=20, batch_size=2048, device="cpu")
    m.fit(X, num_epochs=1, verbose=False, seed=7)
    assert m.engine_ == "packed"
    assert m.static_prep_ == m.prep_backend_ == prep
    steps = -(-X.nnz // 2048)
    r = last_root("bpr.fit")
    for name in ("bpr.batches", "bpr.prep_static"):
        assert r.paths[name].counts["native_steps"] == \
            (steps if prep == "native" else 0), name
    assert r.counts["native_steps"] == (2 * steps if prep == "native"
                                        else 0)


# (the sequential engine is left out: its CPU version copies masks from
# host to host, which no card run does)
@pytest.mark.parametrize("engine,kwargs,prep", [
    ("packed", {}, "device"),
    ("batch", {"packed": "off"}, "host"),
])
def test_bpr_h2d_bytes_count_every_host_copy(monkeypatch, engine, kwargs,
                                             prep):
    """Each BPR engine's ``h2d_bytes`` is every byte its fit hands to the
    device, the hash set of device prep and the batch engine included."""
    monkeypatch.setenv("CYMF_TPU_BPR_PREP", prep)
    X = _interactions(nnz=3000)
    m = ct.BPR(num_components=8, batch_size=1024, device="cpu", **kwargs)
    copies = HostCopies(monkeypatch)
    m.fit(X, num_epochs=2, verbose=False, seed=3)
    monkeypatch.undo()
    assert m.engine_ == engine
    r = last_root("bpr.fit")
    assert r.counts["h2d_bytes"] == copies.bytes > 0


@pytest.mark.parametrize("kwargs,prep,binary", [
    ({"packed": "on"}, "device", True),
    ({"packed": "on"}, "host", True),
    ({"packed": "off"}, "device", True),
    ({"packed": "off"}, "device", False),
])
def test_relmf_h2d_bytes_count_every_host_copy(monkeypatch, kwargs, prep,
                                               binary):
    """RelMF's ``h2d_bytes`` is every byte its fit hands to the device:
    the tables, the propensities, the hash set or the CSR labels, the
    host prep's streams."""
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", prep)
    X = _interactions(U=60, I=40, nnz=500)
    if not binary:
        X.data = np.arange(1.0, X.nnz + 1.0) % 3 + 1.0
    m = ct.RelMF(num_components=8, batch_size=1024, device="cpu", **kwargs)
    copies = HostCopies(monkeypatch)
    m.fit(X, num_epochs=2, seed=3)
    monkeypatch.undo()
    assert m.packed_engine_ == (kwargs["packed"] == "on")
    r = last_root("relmf.fit")
    assert r.counts["h2d_bytes"] == copies.bytes > 0


def test_bpr_verbose_prints_the_fit_rate(capsys):
    X = _interactions(nnz=3000)
    ct.BPR(num_components=8, batch_size=1024, device="cpu").fit(
        X, num_epochs=2, verbose=True, seed=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(line.endswith("/s") for line in lines)


def test_wmf_fit_spans(monkeypatch):
    X = _interactions(U=120, I=90, nnz=1500)
    m = ct.WMF(num_components=8, chunk_size=64, device="cpu")
    copies = HostCopies(monkeypatch)
    m.fit(X, num_epochs=2, verbose=False)
    monkeypatch.undo()
    r = last_root("wmf.fit")
    for name in ("wmf.transpose", "wmf.build_chunks", "wmf.upload"):
        assert r.paths[name].n == 1, name
    assert m.chunks_["build_s"] == pytest.approx(
        r.paths["wmf.transpose"].s + r.paths["wmf.build_chunks"].s)
    assert r.paths["epoch"].n == 2
    assert r.paths["epoch/als.gather"].n > 0
    # the chunks, marked at their making, and both tables, which are
    # padded on the host before their copy
    tables = (120 + 90) * 8 * 4
    assert r.counts["h2d_bytes"] == copies.bytes + tables
    assert r.counts["samples"] == 2 * X.nnz
    assert len(m.epoch_times_) == 2
    assert sum(m.epoch_times_) <= r.paths["epoch"].s


def test_expomf_fit_spans(monkeypatch):
    """One ``expomf.fit`` root: the build and the uploads once, each
    chunk's exposure, Gramian and solve inside each epoch, the Gramians'
    products counted on their span, and every byte handed to the device
    counted."""
    X = _interactions(U=120, I=90, nnz=1500)
    m = ct.ExpoMF(num_components=8, chunk_size=32, device="cpu")
    copies = HostCopies(monkeypatch)
    m.fit(X, num_epochs=2, verbose=False)
    monkeypatch.undo()
    r = last_root("expomf.fit")
    assert not r.error
    for name in ("expomf.build", "expomf.upload"):
        assert r.paths[name].n == 1, name
    assert r.paths["epoch"].n == 2
    chunks = r.paths["epoch/expomf.exposure"].n
    assert chunks >= 2 * 2 * 2       # both sides, several chunks, 2 epochs
    for name in ("expomf.gramian", "expomf.solve"):
        assert r.paths[f"epoch/{name}"].n == chunks, name
    assert r.paths["epoch/expomf.solve/als.gather"].n == chunks
    # the packed Gramian's products: 2 Kp a row and column of each half
    # sweep, Kp = 64 (K (K + 1) / 2 = 36 padded to a multiple of 32)
    assert r.paths["epoch/expomf.gramian"].counts["gramian_flops"] == \
        2 * 2 * (2 * 64 * 120 * 90)
    # the chunks, and the tables and mu, marked at their making
    assert r.counts["h2d_bytes"] == copies.bytes > 0
    assert r.paths["expomf.upload"].counts["h2d_bytes"] == \
        (120 + 90) * 8 * 4 + 90 * 4
    assert r.counts["h2d_bytes"] == (
        r.paths["expomf.build"].counts["h2d_bytes"]
        + r.paths["expomf.upload"].counts["h2d_bytes"])
    assert r.counts["samples"] == 2 * X.nnz
    assert sum(m.epoch_times_) <= r.paths["epoch"].s


def test_evaluate_spans(monkeypatch):
    X = _interactions(U=80, I=60, nnz=900, seed=1)
    T = _interactions(U=80, I=60, nnz=300, seed=2)
    ev = ct.AoaEvaluator(T, X, metrics=["DCG"], k=5, device="cpu")
    W = np.random.default_rng(0).normal(size=(80, 8)).astype(np.float32)
    H = np.random.default_rng(1).normal(size=(60, 8)).astype(np.float32)
    for call in range(2):
        copies = HostCopies(monkeypatch)
        ev.evaluate(W, H)
        monkeypatch.undo()
        r = last_root("eval.evaluate")
        assert set(r.paths) == {"eval.upload", "eval.state", "eval.fetch"}
        assert r.paths["eval.upload"].counts["h2d_bytes"] == \
            W.nbytes + H.nbytes
        # the first call also places the evaluator's own state
        assert ("h2d_bytes" in r.paths["eval.state"].counts) == (call == 0)
        assert r.counts["h2d_bytes"] == copies.bytes

    # under a fit: the tables' fetches and the call, each epoch
    m = ct.BPR(num_components=8, batch_size=1024, device="cpu")
    m.fit(X, num_epochs=2, verbose=False, valid_evaluator=ev)
    f = last_root("bpr.fit")
    assert f.paths["epoch/epoch.evaluate"].n == 2
    assert f.paths["epoch/epoch.evaluate/tables.fetch"].n == 4
    assert f.paths["epoch/epoch.evaluate/eval.evaluate/eval.upload"].n == 2


def test_recommend_spans(monkeypatch):
    rng = np.random.default_rng(3)
    W = rng.normal(size=(70, 8)).astype(np.float32)
    H = rng.normal(size=(50, 8)).astype(np.float32)
    X = sparse.random(70, 50, density=0.2, format="csr", random_state=4)
    copies = HostCopies(monkeypatch)
    ct.recommend(W, H, k=5, exclude=X, user_chunk=32, device="cpu")
    monkeypatch.undo()
    r = last_root("recommend")
    assert r.paths["recommend.upload"].n == 1
    assert r.paths["recommend.exclusions"].n == 1
    assert r.paths["recommend.fetch"].n == 3          # 70 users, 32 a chunk
    assert r.paths["recommend.exclusions"].counts["h2d_bytes"] == \
        X.indptr.astype(np.int64).nbytes + X.indices.nbytes
    # and each chunk's -inf for its exclusions
    assert r.counts["h2d_bytes"] == copies.bytes == W.nbytes + H.nbytes \
        + X.indptr.astype(np.int64).nbytes + X.indices.nbytes + 3 * 4
