"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes and edge cases (tails, empty streams, one-row
runs across warps, re-anchored windows, every slot count).

Needs an NVIDIA GPU; skips without one.  This file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: sample-phase outputs ``rtol 1e-5, atol 1e-6`` and the loss
relative ``1e-5`` (row sums reduce in another order), the v5-v8 kernels'
``SW`` and ``Q`` alike; accumulations ``1e-5 * max|plain|`` absolute
(summation order, atomics); the fused kernels' ``Aw`` and v8's ``Apool``
lane group by lane group: the payload within ``1e-5`` of its own max
(where a slot-placement or lane-rotation fault shows; the count and loss
lanes dwarf it), the count channel and unused lanes exact (sums of 0/1
masks), ``Aw``'s loss lane ``rtol 1e-5``; the count-lane form of the
accumulations alike (payload within ``1e-5`` of its max, the count lane
and the 127 unused lanes exact), the single-stream form also on streams
built to cut runs at every part and CTA boundary, its launch plan against
its scratch layout, and a stream whose live rows decrease failing the
kernel's assert (in a process of its own); the dual form alike on pairs
of those streams at widths 128-640, two calls and its Python twin equal
to the bit, its plan against what the wrapper allocates, and its assert
on either stream; the v8 pool step also on
streams built to break it (one user with 40% of the samples, runs cut at
every part boundary, a padding tail; slots outside the pool; window
ranges that drop samples) at P = 128 and 2048, into outputs left dirty;
the probes P2 and P3 exact, P1's SW and
Q equal to #1's kernel and within #1's bounds of plain; the packed epochs of every pipeline on the card against the
CPU, ``rtol 1e-4, atol 1e-5`` under sgd and adagrad and under adam the
sequential epochs' drift class below; the batched
Cholesky ``|dL| <= 1e-4 max|L|`` and ``|Linv L - I| <= 1e-3``, the JAX
package's own bounds for its kernel, at every B of both instantiations
(16-128, the identity padding included), with a matrix that is not SPD
and one with a NaN pivot among 262; ALS fits ``rtol 2e-3, atol 2e-4``,
its bound between solver forms.  The sequential epochs: tables ``rtol
1e-4, atol 1e-5`` under sgd and adagrad (the dot products' summation
order compounding over the chain), under adam fewer than 1% of elements
outside that and none off by more than ``2.5 lr`` (a first touch whose
tiny gradient flips sign moves a row by ``+-lr``), the loss relative
``1e-5``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import chol_kernel as ck
from cymf_tpu_torch.ops import fused_sample as fs
from cymf_tpu_torch.ops import fused_step as fst
from cymf_tpu_torch.ops import glove_epoch as ge
from cymf_tpu_torch.ops import packed as pk
from cymf_tpu_torch.ops import pallas_engine as pe
from cymf_tpu_torch.ops import probes
from cymf_tpu_torch.ops import sorted_accum as sa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _accum_inputs(rng, B, R, wrows, lo=0, hi=None):
    hi = R if hi is None else hi
    rows = np.sort(rng.integers(lo, hi, B)).astype(np.int32)
    rows2d = sa.pad_samples(rows, R)                 # sentinel = R
    g = rng.normal(size=(rows2d.size, 128)).astype(np.float32)
    starts, counts = sa.window_ranges(rows2d.reshape(-1)[:B], R, wrows,
                                      1024, align=128)
    return rows2d, g, starts, counts


def _close_accum(got, want):
    torch.cuda.synchronize()
    scale = max(float(want.abs().max()), 1.0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * scale


def _close_lanes(got, want, groups):
    """``groups``: ``(name, lanes, rtol, rel)``, each group within ``rel *
    max|want over the group| + rtol |want|``."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for name, lanes, rtol, rel in groups:
        w = want[:, lanes]
        if w.numel():
            torch.testing.assert_close(
                got[:, lanes], w, rtol=rtol, atol=rel * float(w.abs().max()),
                msg=lambda m, name=name: f"lanes {name}: {m}")


def _close_aw(Aw, Awp, K):
    s, cb = pk.num_slots(K), pk.count_base(K)
    _close_lanes(Aw, Awp, [("payload", slice(0, cb), 0.0, 1e-5),
                           ("counts", slice(cb, cb + s), 0.0, 0.0),
                           ("unused", slice(cb + s, fst.LOSS_LANE), 0.0, 0.0),
                           ("loss", slice(fst.LOSS_LANE, None), 1e-5, 0.0)])


def _close_apool(Ap, App, K):
    _close_lanes(Ap, App, [("payload", slice(0, K), 0.0, 1e-5),
                           ("counts", slice(K, K + 1), 0.0, 0.0),
                           ("unused", slice(K + 1, None), 0.0, 0.0)])


@pytest.mark.parametrize("B,R,wrows,lo,hi", [
    (3000, 1024, 256, 0, None),
    (4096, 512, 128, 100, 103),     # three rows: runs span every warp
    (2048, 2048, 256, 0, 300),      # most windows empty
    (0, 256, 128, 0, None),         # empty stream
    (10000, 512, 128, 0, None),
    (20000, 2048, 512, 0, None),    # the JAX default window: two slices
    (8192, 2048, 1024, 900, 1300),  # four slices, runs across slices
    (3000, 1056, 264, 0, None),     # slices of a window not a power of 2
])
def test_sorted_accum_kernel(dev, B, R, wrows, lo, hi):
    rng = np.random.default_rng(B + R)
    arrs = [torch.from_numpy(a).to(dev)
            for a in _accum_inputs(rng, B, R, wrows, lo, hi)]
    _kernels.reset_launches()
    got = sa.sorted_accum(*arrs, r_pad=R, wrows=wrows)
    assert _kernels.launches["sorted_accum"] == 1
    _close_accum(got, sa.sorted_accum_plain(*arrs, r_pad=R, wrows=wrows))


@pytest.mark.parametrize("Bi,Bj,R,wrows,neg", [
    (2048, 2048, 512, 256, 20),
    (3000, 1024, 1024, 128, 33),
    (0, 1024, 256, 128, 64),
    (1024, 0, 256, 128, 100),
    (20000, 30000, 2048, 512, 20),
])
def test_sorted_accum_dual_kernel(dev, Bi, Bj, R, wrows, neg):
    rng = np.random.default_rng(Bi * 3 + Bj)
    a = [torch.from_numpy(x).to(dev)
         for x in _accum_inputs(rng, Bi, R, wrows)
         + _accum_inputs(rng, Bj, R, wrows)]
    _kernels.reset_launches()
    got = sa.sorted_accum_dual(*a, r_pad=R, neg_lanes=neg, wrows=wrows)
    assert _kernels.launches["sorted_accum_dual"] == 1
    _close_accum(got, sa.sorted_accum_dual_plain(*a, r_pad=R, neg_lanes=neg,
                                                 wrows=wrows))


def _wide_inputs(rng, B, R, wrows, width, lo=0, hi=None, live=0.8):
    """A sorted stream of ``width``-lane rows, its dead samples routed to
    the sentinel R (as the wide engine routes them)."""
    hi = R if hi is None else hi
    rows = np.sort(rng.integers(lo, hi, B)).astype(np.int32)
    starts, counts = sa.window_ranges(rows, R, wrows, 1024, align=128)
    rows2d = sa.pad_samples(np.where(rng.random(B) < live, rows, R)
                            .astype(np.int32), R)
    g = rng.normal(size=(rows2d.size, width)).astype(np.float32)
    return rows2d, g, starts, counts


def _close_counted(got, want, width):
    """The wide form by lane group: payload within 1e-5 of its own max,
    the count lane and the 127 unused lanes exact."""
    _close_lanes(got, want, [("payload", slice(0, width), 0.0, 1e-5),
                             ("counts", slice(width, width + 1), 0.0, 0.0),
                             ("unused", slice(width + 1, None), 0.0, 0.0)])


@pytest.mark.parametrize("width", [256, 384])
@pytest.mark.parametrize("B,R,wrows,lo,hi", [
    (3000, 1024, 128, 0, None),
    (20000, 2048, 512, 0, None),    # wrows 512: three slices at width 256
    (8192, 2048, 512, 100, 400),    # runs across slices
    (0, 1024, 512, 0, None),        # empty stream
])
def test_sorted_accum_count_lanes_kernel(dev, width, B, R, wrows, lo, hi):
    rng = np.random.default_rng(B + R + width)
    arrs = [torch.from_numpy(a).to(dev)
            for a in _wide_inputs(rng, B, R, wrows, width, lo, hi)]
    _kernels.reset_launches()
    got = sa.sorted_accum(*arrs, r_pad=R, wrows=wrows, count_lanes=True)
    assert dict(_kernels.launches) == {"sorted_accum_wide": 1}
    assert got.shape == (R, width + 128)
    _close_counted(got, sa.sorted_accum_plain(*arrs, r_pad=R, wrows=wrows,
                                              count_lanes=True), width)


@pytest.mark.parametrize("width", [256, 384])
@pytest.mark.parametrize("Bi,Bj,R,wrows", [
    (2048, 3000, 1024, 128),
    (20000, 30000, 2048, 512),
    (0, 4096, 1024, 512),           # empty i stream
])
def test_sorted_accum_dual_count_lanes_kernel(dev, width, Bi, Bj, R, wrows):
    rng = np.random.default_rng(Bi + Bj + width)
    a = [torch.from_numpy(x).to(dev)
         for x in _wide_inputs(rng, Bi, R, wrows, width)
         + _wide_inputs(rng, Bj, R, wrows, width)]
    _kernels.reset_launches()
    got = sa.sorted_accum_dual(*a, r_pad=R, neg_lanes=width, wrows=wrows,
                               count_lanes=True)
    assert dict(_kernels.launches) == {"sorted_accum_dual_wide": 1}
    _close_counted(got, sa.sorted_accum_dual_plain(
        *a, r_pad=R, neg_lanes=width, wrows=wrows, count_lanes=True), width)


@pytest.mark.parametrize("width,count", [(256, False), (128, True),
                                         (640, True)])
def test_sorted_accum_wide_widths(dev, width, count):
    """Widths without the count granule, the count granule at width 128,
    and a width past one walk's four granules (two walks a range)."""
    rng = np.random.default_rng(width)
    arrs = [torch.from_numpy(a).to(dev)
            for a in _wide_inputs(rng, 5000, 1024, 512, width)]
    got = sa.sorted_accum(*arrs, r_pad=1024, wrows=512, count_lanes=count)
    want = sa.sorted_accum_plain(*arrs, r_pad=1024, wrows=512,
                                 count_lanes=count)
    if count:
        _close_counted(got, want, width)
    else:
        _close_accum(got, want)


# Streams that stress the single-stream kernel's partition into parts of
# 64 samples and CTAs of 512 (sa.segment_twin holds the same streams on the
# CPU, tests/test_torch_sorted_accum.py).
SEGMENT_STREAMS = ("power-law", "long-run", "blocks", "sentinels",
                   "broken-run", "padding-tail", "all-sentinels", "last-row",
                   "sparse")


def segment_streams(R: int = 4096) -> dict:
    """``{name: rows}`` into ``R`` output rows, live rows non-decreasing,
    rows outside ``[0, R)`` anywhere: a power law whose first 256 rows hold
    about half the samples; one row's run longer than a CTA's share; runs
    of 1, 31, 32, 33, 63, 64, 65, 257, 511, 512 and 513 samples, cut at
    every part and CTA boundary; 30% sentinels interleaved; one row's run
    broken by sentinels across one part boundary and across two (with -1
    as the sentinel); a padding tail; no live sample; the last live row at
    ``R - 1`` with 5,003 samples (not a multiple of a share); five live
    samples among 20,000 (long gaps between parts, and a long and a short
    one inside a part)."""
    rng = np.random.default_rng(7)
    w = np.arange(1, R + 1) ** -0.8
    sizes = [1, 31, 32, 33, 63, 64, 65, 257, 511, 512, 513]
    mixed = np.sort(rng.integers(0, R, 6000))
    mixed[rng.random(6000) < 0.3] = R + 1000
    broken = np.full(400, 9)
    broken[56:72] = R          # samples 116-131: the part boundary at 128
    broken[200:330] = -1       # samples 260-389: those at 320 and 384
    sparse = np.full(20000, R)
    sparse[[5, 6, 40, 9000, 19999]] = [2, 900, 920, 1000, 4000]
    streams = {
        "power-law": np.sort(rng.choice(R, 20000, p=w / w.sum())),
        "long-run": np.repeat([3, 7, 8], [50, 3000, 20]),
        "blocks": np.repeat(np.arange(3 * len(sizes)), sizes * 3),
        "sentinels": mixed,
        "broken-run": np.concatenate([np.repeat([1, 2], 30), broken,
                                      np.repeat([10, 11], 100)]),
        "padding-tail": np.concatenate([np.sort(rng.integers(0, R, 1000)),
                                        np.full(5000, R)]),
        "all-sentinels": np.full(3000, R),
        "last-row": np.sort(np.append(rng.integers(R - 300, R, 5002),
                                      R - 1)),
        "sparse": sparse,
    }
    return {k: v.astype(np.int32) for k, v in streams.items()}


# Pairs of those streams for the dual kernel (i stream, j stream): both on
# the same rows, runs of one stream cut where the other's are not, one
# stream empty, both with no live sample.
DUAL_PAIRS = (("power-law", "power-law"), ("power-law", "sentinels"),
              ("long-run", "blocks"), ("broken-run", "padding-tail"),
              ("sparse", "last-row"), ("empty", "long-run"),
              ("sentinels", "empty"), ("all-sentinels", "all-sentinels"))


def dual_streams(pair, R: int = 4096):
    """The rows of the i and j streams of ``pair`` (``"empty"``: no
    sample)."""
    streams = segment_streams(R)
    return tuple(np.zeros(0, np.int32) if name == "empty" else streams[name]
                 for name in pair)


def _dirty(dev, nbytes):
    """Leaves NaNs in the caching allocator's free blocks, so that a row
    a kernel fails to write shows in the next ``torch.empty``."""
    torch.full((nbytes // 4 + 1,), float("nan"), device=dev)


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("width", [128, 256, 384])
@pytest.mark.parametrize("stream", SEGMENT_STREAMS)
def test_sorted_accum_segment_streams(dev, stream, width, count):
    """The single-stream kernel (#2, and #2w with the count granule) on
    the adversarial streams, every row written (zeros included) into a
    buffer left dirty: payload within 1e-5 of its max, counts and unused
    lanes exact."""
    R, wrows = 4096, 512
    rows = segment_streams(R)[stream]
    g = np.random.default_rng(width).normal(
        size=(rows.size, width)).astype(np.float32)
    r, x = torch.from_numpy(rows).to(dev), torch.from_numpy(g).to(dev)
    win = torch.zeros(R // wrows, dtype=torch.int32, device=dev)
    _dirty(dev, 4 * R * (width + 128))
    _kernels.reset_launches()
    got = sa.sorted_accum(r, x, win, win, r_pad=R, wrows=wrows,
                          count_lanes=count)
    name = "sorted_accum_wide" if count or width != 128 else "sorted_accum"
    assert dict(_kernels.launches) == {name: 1}
    want = sa.sorted_accum_plain(r, x, win, win, r_pad=R, wrows=wrows,
                                 count_lanes=count)
    if count:
        _close_counted(got, want, width)
    else:
        _close_accum(got, want)
    if stream == "all-sentinels":
        assert not got.any()


@pytest.mark.parametrize("n,r_pad,width", [
    (131072, 23296, 128),     # ML-20M d=20, W side
    (131072, 138752, 256),    # ML-20M d=256, W side
    (5003, 4096, 384),
    (1, 128, 128),
    (0, 256, 128),
])
def test_segment_plan_sizes(dev, n, r_pad, width):
    """The kernel library's plan: parts of ``part`` samples cover the
    stream, CTAs of ``share / part`` parts cover the parts, and the scratch
    holds two slots a part (width floats and a count each), the part's
    first and last live row and a byte a row."""
    plan = sa.segment_plan(n, r_pad, width)
    part, parts, blocks = plan["part"], plan["parts"], plan["blocks"]
    per = plan["share"] // part
    assert plan["share"] == part * per and per >= 1
    assert (parts - 1) * part < n <= parts * part or n == parts == 0
    assert (blocks - 1) * per < parts <= blocks * per or parts == blocks == 0
    assert plan["scratch_bytes"] == (2 * parts * (4 * width + 4)
                                     + 2 * parts * 4 + r_pad)
    if n == 131072:
        assert (part, parts, blocks) == (64, 2048, 256)
    # the partition the twin checks on the CPU, at the kernel's sizes
    rows = segment_streams()["blocks"]
    t = sa.segment_twin(rows, 4096, part, plan["zero_gap"])
    np.testing.assert_array_equal(t["writes"], np.ones(4096))


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("width", [128, 256, 384, 640])
@pytest.mark.parametrize("pair", DUAL_PAIRS, ids="+".join)
def test_sorted_accum_dual_pairs(dev, pair, width, count):
    """The dual kernel (#3, and #3w with the count granule) on pairs of
    the adversarial streams, into a buffer left dirty: payload within 1e-5
    of its max, counts and unused lanes exact, one launch; a second call
    gives the same bits (a row gets at most one i-stream run sum, added
    onto the j stream's stored row), and so does the twin, which forms
    the sums in the kernel's order (``sa.dual_twin``)."""
    R, wrows = 4096, 512
    neg = width if count else 20
    streams = dual_streams(pair, R)
    rng = np.random.default_rng(width)
    g = [rng.normal(size=(r.size, width)).astype(np.float32)
         for r in streams]
    win = torch.zeros(R // wrows, dtype=torch.int32, device=dev)
    a = []
    for rows, x in zip(streams, g):
        a += [torch.from_numpy(rows).to(dev), torch.from_numpy(x).to(dev),
              win, win]
    kw = dict(r_pad=R, neg_lanes=neg, wrows=wrows, count_lanes=count)
    _dirty(dev, 4 * R * (width + 128))
    _kernels.reset_launches()
    got = sa.sorted_accum_dual(*a, **kw)
    name = ("sorted_accum_dual_wide" if count or width != 128
            else "sorted_accum_dual")
    assert dict(_kernels.launches) == {name: 1}
    want = sa.sorted_accum_dual_plain(*a, **kw)
    if count:
        _close_counted(got, want, width)
    else:
        _close_accum(got, want)
    _dirty(dev, 4 * R * (width + 128))
    again = sa.sorted_accum_dual(*a, **kw)
    torch.cuda.synchronize()
    bits = got.cpu().numpy().view(np.int32)
    np.testing.assert_array_equal(again.cpu().numpy().view(np.int32), bits)
    plan = sa.segment_plan(1, R, width)
    twin = sa.dual_twin(streams[0], g[0], streams[1], g[1], R, plan["part"],
                        plan["zero_gap"], neg, count_lanes=count)
    np.testing.assert_array_equal(twin["out"].view(np.int32), bits)


@pytest.mark.parametrize("n_i,n_j,r_pad,width", [
    (131072, 131072, 26880, 128),    # ML-20M d=20, H side
    (131072, 131072, 27136, 384),    # ML-20M d=256, H side, + counts
    (5003, 0, 4096, 640),
    (1, 64, 128, 128),
    (0, 0, 256, 128),
])
def test_dual_plan_sizes(dev, monkeypatch, n_i, n_j, r_pad, width):
    """The dual plan: each stream's parts in CTAs of ``share / part``
    parts; two slots a part (width floats and a count each) and the part's
    first and last live row, and the j stream's mark a row (the i stream
    adds, unmarked); and the wrapper allocates exactly the plan's
    scratch."""
    plan = sa.dual_plan(n_i, n_j, r_pad, width)
    part, pi, pj = plan["part"], plan["parts_i"], plan["parts_j"]
    assert (pi, pj) == (-(-n_i // part), -(-n_j // part))
    per = plan["share"] // part
    assert plan["blocks_i"] == -(-pi // per)
    assert plan["blocks_j"] == -(-pj // per)
    assert plan["scratch_bytes"] == (2 * (pi + pj) * (4 * width + 4)
                                     + 2 * (pi + pj) * 4 + r_pad)
    if n_i == 131072:
        assert (part, pi, plan["blocks_i"]) == (64, 2048, 256)
    asked, real = [], torch.empty

    def spy(*shape, **kw):
        if kw.get("dtype") is torch.uint8:
            asked.append(shape[0])
        return real(*shape, **kw)

    a = []
    for n in (n_i, n_j):
        a += [torch.full((n,), r_pad, dtype=torch.int32, device=dev),
              torch.zeros(n, width, device=dev)] + [
            torch.zeros(r_pad // 128, dtype=torch.int32, device=dev)] * 2
    monkeypatch.setattr(torch, "empty", spy)
    out = sa.sorted_accum_dual(*a, r_pad=r_pad, neg_lanes=width,
                               wrows=128, count_lanes=width != 128)
    monkeypatch.undo()
    assert asked == [plan["scratch_bytes"]]
    assert not out.any()


# live rows that decrease inside a part, and between two parts
DECREASING = {"inside a part": [5, 7, 3, 9],
              "across parts": [10] * 64 + [3] * 64}


@pytest.mark.parametrize("case", sorted(DECREASING))
def test_sorted_accum_asserts_sorted_live_rows(dev, case):
    """A stream that breaks the kernel's precondition fails its
    device-side assert instead of losing sums; the assert leaves the CUDA
    context unusable, so the call runs in a process of its own."""
    code = (
        "import torch\n"
        "from cymf_tpu_torch.ops import sorted_accum as sa\n"
        f"rows = torch.tensor({DECREASING[case]}, dtype=torch.int32,\n"
        "                    device='cuda')\n"
        "g = torch.ones(rows.numel(), 128, device='cuda')\n"
        "win = torch.zeros(1, dtype=torch.int32, device='cuda')\n"
        "sa.sorted_accum(rows, g, win, win, r_pad=128, wrows=128)\n"
        "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0
    assert "live rows must be non-decreasing" in proc.stdout + proc.stderr


@pytest.mark.parametrize("stream", ["i", "j"])
@pytest.mark.parametrize("case", sorted(DECREASING))
def test_sorted_accum_dual_asserts_sorted_live_rows(dev, case, stream):
    """The dual kernel asserts the precondition on each stream: one whose
    live rows decrease (the other sorted) fails the device-side assert, in
    a process of its own."""
    bad = DECREASING[case]
    rows_i, rows_j = (bad, sorted(bad)) if stream == "i" else (sorted(bad),
                                                               bad)
    code = (
        "import torch\n"
        "from cymf_tpu_torch.ops import sorted_accum as sa\n"
        "def side(rows):\n"
        "    r = torch.tensor(rows, dtype=torch.int32, device='cuda')\n"
        "    win = torch.zeros(1, dtype=torch.int32, device='cuda')\n"
        "    return [r, torch.ones(r.numel(), 128, device='cuda'), win, win]\n"
        f"sa.sorted_accum_dual(*side({rows_i}), *side({rows_j}), r_pad=128,\n"
        "                     neg_lanes=20, wrows=128)\n"
        "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0
    assert "live rows must be non-decreasing" in proc.stdout + proc.stderr


def _probe_tiles(dev, B, K=20, seed=0):
    """Decorated packed W rows and logical item rows, zero on lanes >= K."""
    rng = np.random.default_rng(seed)
    s, cb = pk.num_slots(K), pk.count_base(K)
    Du = rng.normal(size=(B, 128)).astype(np.float32)
    Du[:, cb:] = 0.0
    Du[np.arange(B), cb + rng.integers(0, s, B)] = rng.random(B) > 0.1
    Di, Dj = (rng.normal(size=(B, 128)).astype(np.float32) for _ in "ij")
    Di[:, K:] = 0.0
    Dj[:, K:] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (Du, Di, Dj)]


@pytest.mark.parametrize("K,B", [(20, 2048), (33, 1000), (20, 1)])
def test_phase_v4r_kernel(dev, K, B):
    """P1: SW and Q equal to #1's kernel bit for bit (one reduction order),
    within #1's bounds of plain; the loss within 1e-5 relative."""
    tiles = _probe_tiles(dev, B, K)
    _kernels.reset_launches()
    SW, Q, loss = probes.phase_v4r(*tiles, K=K, wd=0.01)
    assert dict(_kernels.launches) == {"phase_v4r": 1}
    SW1, Q1, loss1 = fs.bpr_sample_phase(*tiles, K=K, wd=0.01)
    torch.testing.assert_close(SW, SW1, rtol=0.0, atol=0.0)
    torch.testing.assert_close(Q, Q1, rtol=0.0, atol=0.0)
    SWp, Qp, lossp = probes.phase_v4r_plain(*tiles, K=K, wd=0.01)
    torch.testing.assert_close(SW, SWp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Q, Qp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("B", [1, 1024, 131072])
def test_copy_phase_kernel(dev, B):
    tiles = _probe_tiles(dev, B)
    _kernels.reset_launches()
    got = probes.copy_phase(*tiles)
    assert dict(_kernels.launches) == {"copy_phase": 1}
    for g, w in zip(got, probes.copy_phase_plain(*tiles)):
        torch.testing.assert_close(g, w, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("q", [1, 8, 16])
@pytest.mark.parametrize("R,W,B,sort", [(27136, 128, 4096, False),
                                        (1000, 256, 777, True),
                                        (50, 4, 1, False),
                                        (300, 384, 0, False)])
def test_gather_rows_kernel(dev, q, R, W, B, sort):
    rng = np.random.default_rng(R + W + B)
    T = torch.from_numpy(rng.normal(size=(R, W)).astype(np.float32)).to(dev)
    idx = rng.integers(0, R, B).astype(np.int32)
    idx = torch.from_numpy(np.sort(idx) if sort else idx).to(dev)
    _kernels.reset_launches()
    got = probes.gather_rows(T, idx, rows_in_flight=q)
    assert dict(_kernels.launches) == {"gather_rows": 1}
    torch.testing.assert_close(got, probes.gather_rows_plain(T, idx),
                               rtol=0.0, atol=0.0)


def test_probes_raise_on_what_kernels_do_not_take(dev):
    T = torch.zeros(10, 6, device=dev)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.gather_rows(T, idx)
    with pytest.raises(ValueError, match="dtype"):
        probes.gather_rows(torch.zeros(10, 8, device=dev), idx.long())
    x = torch.zeros(64, 128, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        probes.copy_phase(x.double(), x.double(), x.double())


@pytest.mark.parametrize("K,B", [(20, 1024), (33, 1000), (64, 64),
                                 (100, 777), (20, 1)])
def test_bpr_sample_kernel(dev, K, B):
    rng = np.random.default_rng(K * B)
    s = pk.num_slots(K)
    Wp = torch.from_numpy(pk.pack_array(rng.normal(size=(300, K)), K)).to(dev)
    Hp = torch.from_numpy(pk.pack_logical(rng.normal(size=(200, K)), K)
                          ).to(dev)
    u = torch.from_numpy(np.sort(rng.integers(0, 300, B)).astype(np.int32)
                         ).to(dev)
    mf = torch.from_numpy((rng.random(B) > 0.2).astype(np.float32)).to(dev)
    Du = fs.decorate(Wp.index_select(0, u // s), u % s, mf, K)
    Di = Hp[torch.from_numpy(rng.integers(0, 200, B)).to(dev)]
    Dj = Hp[torch.from_numpy(rng.integers(0, 200, B)).to(dev)]
    _kernels.reset_launches()
    SW, Q, loss = fs.bpr_sample_phase(Du, Di, Dj, K=K, wd=0.01)
    assert _kernels.launches["bpr_sample_phase"] == 1
    SWp, Qp, lossp = fs.bpr_sample_phase_plain(Du, Di, Dj, K=K, wd=0.01)
    torch.testing.assert_close(SW, SWp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Q, Qp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("Kp", [10, 20, 52])
@pytest.mark.parametrize("B", [1024, 131072])
def test_glove_sample_kernel(dev, B, Kp):
    """Every slot count of RelMF (Kp = K) and GloVe (Kp = K + 2), a tenth
    of the rows dead (mask 0: padding, masked samples)."""
    rng = np.random.default_rng(B + Kp)
    s = pk.num_slots(Kp)
    Zc = torch.from_numpy(pk.pack_array(
        rng.normal(size=(3000, Kp)) * 0.3, Kp).astype(np.float32)).to(dev)
    Zx = torch.from_numpy(pk.pack_logical(
        rng.normal(size=(2000, Kp)) * 0.3, Kp).astype(np.float32)).to(dev)
    c = torch.from_numpy(np.sort(rng.integers(0, 3000, B)).astype(np.int32)
                         ).to(dev)
    mf = torch.from_numpy((rng.random(B) > 0.1).astype(np.float32)).to(dev)
    Du = fs.decorate(Zc.index_select(0, c // s), c % s, mf, Kp)
    f = torch.from_numpy(rng.uniform(0.1, 1.0, B).astype(np.float32)).to(dev)
    logcnt = torch.from_numpy(np.log(rng.uniform(1, 50, B)).astype(
        np.float32)).to(dev)
    Dx = ge.decorate_x(Zx.index_select(0, torch.from_numpy(
        rng.integers(0, 2000, B)).to(dev)), f, logcnt, Kp)
    _kernels.reset_launches()
    SW, Q, loss = ge.glove_sample_phase(Du, Dx, Kp=Kp)
    assert _kernels.launches["glove_sample_phase"] == 1
    SWp, Qp, lossp = ge.glove_sample_phase_plain(Du, Dx, Kp=Kp)
    torch.testing.assert_close(SW, SWp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Q, Qp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)
    dead = mf == 0
    assert not SW[dead].any() and not Q[dead].any()


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    g = torch.zeros(1024, 128, device=dev)
    rows = torch.zeros(1024, dtype=torch.int32, device=dev)
    win = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        sa.sorted_accum(rows.long(), g, win, win, r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="on cpu"):
        sa.sorted_accum(rows.cpu(), g, win, win, r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="one entry per window"):
        sa.sorted_accum(rows, g, win[:1], win[:1], r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="width"):
        sa.sorted_accum(rows, torch.zeros(1024, 200, device=dev), win, win,
                        r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="aligned"):
        x = torch.zeros(65 * 128 + 1, device=dev)[1:].view(65, 128)
        fs.bpr_sample_phase(x, x, x, K=20, wd=0.0)
    with pytest.raises(ValueError, match="aligned"):
        ge.glove_sample_phase(x, x, Kp=20)
    with pytest.raises(ValueError, match="dtype"):
        ge.glove_sample_phase(g.double(), g.double(), Kp=20)


PAD_USER = np.int32(2**31 - 1)


def _bpr_step(rng, U, K, B, wrows, pad=300, I=500):
    """Tables and one user-sorted BPR step with a padding tail, as the
    trainer builds them (numpy)."""
    s = pk.num_slots(K)
    Wp = pk.pack_array(rng.normal(size=(U, K)) * 0.3, K, multiple=wrows)
    Hp = pk.pack_logical(rng.normal(size=(I, K)) * 0.3, K, multiple=wrows)
    u = np.sort(rng.integers(0, U, B)).astype(np.int32)
    u[B - pad:] = PAD_USER
    mf = ((rng.random(B) > 0.1) & (u < U)).astype(np.float32)
    return dict(Wp=Wp, Hp=Hp, u=u, phys=(u // s).astype(np.int32),
                i=rng.integers(0, I, B), j=rng.integers(0, I, B), mf=mf,
                rw=Wp.shape[0])


def _on(dev, *arrays):
    """Copies on ``dev`` (on the CPU a tensor made from a numpy array would
    share its memory, and the epochs update their tables in place)."""
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _decorated_rows(table, rows, u, mf, K, dev):
    s = pk.num_slots(K)
    T, r, uu, m = _on(dev, table, rows.astype(np.int64), u, mf)
    return fs.decorate(T.index_select(0, r), uu % s, m, K)


def _close_rows(got, want, rtol=1e-5, atol=1e-6):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("U,K,B", [(290, 20, 1024), (6040, 20, 131072),
                                   (300, 41, 4096), (400, 62, 2048),
                                   (12000, 20, 2048)])   # last: refused
def test_bpr_sample_v5_kernel(dev, U, K, B):
    rng = np.random.default_rng(U + K)
    st = _bpr_step(rng, U, K, B, 8)
    win = min(fs.WROWS_A, st["rw"])
    wstart = np.clip(st["phys"][::fs.TILE], 0, max(st["rw"] - win, 0))
    Wp, ws, rows, Hp, i = _on(dev, st["Wp"], wstart.astype(np.int32),
                              st["phys"], st["Hp"], st["i"])
    Di = Hp.index_select(0, i)
    Dj = _decorated_rows(st["Hp"], st["j"], st["u"], st["mf"], K, dev)
    _kernels.reset_launches()
    SW, Q, loss = fs.bpr_sample_phase_v5(Wp, ws, rows, Di, Dj, K=K, wd=0.01)
    assert _kernels.launches["bpr_sample_phase_v5"] == 1
    SWp, Qp, lossp = fs.bpr_sample_phase_v5_plain(Wp, ws, rows, Di, Dj, K=K,
                                                  wd=0.01)
    _close_rows(SW, SWp)
    _close_rows(Q, Qp)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("U,B", [(4000, 4096), (6040, 131072),
                                 (12000, 2048), (60000, 32768)])
def test_bpr_block_step_v6_kernel(dev, U, B):
    K, wrows = 20, 512
    rng = np.random.default_rng(U + B)
    st = _bpr_step(rng, U, K, B, wrows)
    rw = st["rw"]
    wstart = np.clip(st["phys"][::fst.TILE], 0, rw - fst.CROWS).astype(
        np.int32)
    cs, cn = fst.prep_blocks(wstart, rw, wrows)
    Wp, rows, Hp, i, ws, cs_d, cn_d = _on(dev, st["Wp"], st["phys"],
                                          st["Hp"], st["i"], wstart, cs, cn)
    Di = Hp.index_select(0, i)
    Dj = _decorated_rows(st["Hp"], st["j"], st["u"], st["mf"], K, dev)
    args = (Wp, rows, Di, Dj, ws, cs_d, cn_d)
    _kernels.reset_launches()
    Aw, Q = fst.bpr_block_step_v6(*args, K=K, wd=0.01, rw=rw, wrows=wrows)
    assert _kernels.launches["bpr_block_step_v6"] == 1
    Awp, Qp = fst.bpr_block_step_v6_plain(*args, K=K, wd=0.01, rw=rw,
                                          wrows=wrows)
    _close_rows(Q, Qp)
    _close_aw(Aw, Awp, K)


def _range_inputs(dev, U, K, B, wrows, monkeypatch):
    from cymf_tpu_torch.ops import packed_epoch as tpe
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL", "7")
    rng = np.random.default_rng(U + K + B)
    st = _bpr_step(rng, U, K, B, wrows)
    rw = st["rw"]
    winw, *_, v = tpe.prep_static(st["u"][None], st["i"][None], K, rw,
                                  pk.logical_rows(500, wrows), wrows, wrows)
    assert v == 7
    rows, Hp, i, j, starts, counts = _on(dev, st["phys"], st["Hp"], st["i"],
                                         st["j"], winw[0, 0], winw[0, 1])
    Du = _decorated_rows(st["Wp"], np.minimum(st["phys"], rw - 1), st["u"],
                         st["mf"], K, dev)
    return st, rw, rows, Du, Hp, Hp.index_select(0, i), j, starts, counts


@pytest.mark.parametrize("U,K,B,wrows", [(12000, 20, 2048, 512),
                                         (3000, 41, 2048, 256),
                                         (138493, 20, 131072, 256),
                                         (50000, 20, 32768, 1024)])
def test_bpr_range_step_v7_kernel(dev, U, K, B, wrows, monkeypatch):
    st, rw, rows, Du, Hp, Di, j, starts, counts = _range_inputs(
        dev, U, K, B, wrows, monkeypatch)
    args = (rows, Du, Di, Hp.index_select(0, j), starts, counts)
    _kernels.reset_launches()
    Aw, Q = fst.bpr_range_step_v7(*args, K=K, wd=0.01, rw=rw, wrows=wrows)
    assert _kernels.launches["bpr_range_step_v7"] == 1
    Awp, Qp = fst.bpr_range_step_v7_plain(*args, K=K, wd=0.01, rw=rw,
                                          wrows=wrows)
    _close_rows(Q, Qp)
    _close_aw(Aw, Awp, K)


POOL_STREAMS = ("heavy-user", "part-cuts", "padding-tail")


def pool_streams(B: int = 4096, U: int = 3000, K: int = 20) -> dict:
    """``{name: u}``: user-sorted BPR steps of ``B`` samples for the v8
    pool step (packed rows ``u // num_slots(K)``), each with a tail of
    ``PAD_USER`` samples: one user holding 40% of the samples; runs of
    one packed row of 1, 31-33, 63-65, 127-129, 257, 511 and 513 samples
    back to back, cut at every part boundary; 1,200 live samples and a
    2,896-sample padding tail."""
    rng = np.random.default_rng(8)
    s = pk.num_slots(K)
    heavy = np.concatenate([np.full(int(0.4 * B), 7),
                            rng.integers(0, U, B - int(0.4 * B) - 300)])
    sizes = [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 257, 511, 513]
    runs = np.repeat(np.arange(len(sizes) * 2) * 3, sizes * 2)[:B - 300]
    streams = {"heavy-user": np.sort(heavy),
               "part-cuts": runs * s + rng.integers(0, s, runs.size),
               "padding-tail": np.sort(rng.integers(0, U, 1200))}
    return {k: np.concatenate([v, np.full(B - v.size, PAD_USER)]).astype(
        np.int32) for k, v in streams.items()}


def pool_slots(B: int, P: int) -> np.ndarray:
    """Per-sample pool slots, about one in nine outside ``[0, P)`` (-1
    or ``P`` and above), which the kernel must treat as no pool row."""
    return np.random.default_rng(P).integers(-1, P + P // 8, B).astype(
        np.int32)


def drop_samples(counts: np.ndarray) -> np.ndarray:
    """Window counts that drop samples, so that the keep rule decides:
    every third window's range cut by 1,100 samples (more than a tile, the
    unit in which a range counts; a short one goes negative), and the
    second window's range empty."""
    counts = np.maximum(counts - np.where(np.arange(counts.size) % 3, 0,
                                          1100), -5).astype(np.int32)
    if counts.size > 1:
        counts[1] = 0
    return counts


def _pool_case(dev, u, P, drop, K=20, wrows=256, I=500):
    """The v8 inputs of step ``u`` on ``dev`` (the port's pool prep)."""
    from cymf_tpu_torch.ops import packed_epoch as tpe
    rng = np.random.default_rng(u.size + P)
    B, s = u.size, pk.num_slots(K)
    U = int(u[u < PAD_USER].max()) + 1
    Wp = pk.pack_array(rng.normal(size=(U, K)) * 0.3, K, multiple=wrows)
    Hp = pk.pack_logical(rng.normal(size=(I, K)) * 0.3, K, multiple=wrows)
    rw = Wp.shape[0]
    i = rng.integers(0, I, B)
    winw, *_ = tpe.prep_static_pool(u[None], i[None], K, rw,
                                    pk.logical_rows(I, wrows), wrows, wrows)
    starts, counts = winw[0]
    if drop:
        counts = drop_samples(counts)
    mf = ((rng.random(B) > 0.1) & (u < U)).astype(np.float32)
    phys = (u // s).astype(np.int32)
    pool = rng.integers(0, I, P)
    rows, rj, st, ct, Hpd, id_, pl = _on(dev, phys, pool_slots(B, P),
                                         starts, counts, Hp, i, pool)
    Du = _decorated_rows(Wp, np.minimum(phys, rw - 1), u, mf, K, dev)
    return (rows, rj, Du, Hpd.index_select(0, id_), Hpd.index_select(0, pl),
            st, ct), dict(K=K, wd=0.01, rw=rw, wrows=wrows)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("P", [128, 2048])
@pytest.mark.parametrize("stream", POOL_STREAMS)
def test_bpr_pool_step_v8_kernel_adversarial(dev, stream, P, drop):
    """#7 on the adversarial streams, pool slots outside the pool, and
    window ranges that drop samples, into outputs left dirty: Aw and
    Apool by lane group, Q for every sample."""
    args, kw = _pool_case(dev, pool_streams()[stream], P, drop)
    _dirty(dev, 4 * 128 * (args[2].shape[0] + kw["rw"]))
    _kernels.reset_launches()
    Aw, Ap, Q = fst.bpr_pool_step_v8(*args, **kw)
    assert dict(_kernels.launches) == {"bpr_pool_step_v8": 1}
    Awp, App, Qp = fst.bpr_pool_step_v8_plain(*args, **kw)
    _close_rows(Q, Qp)
    _close_aw(Aw, Awp, kw["K"])
    _close_apool(Ap, App, kw["K"])


@pytest.mark.parametrize("P,U,B", [(128, 12000, 2048), (1024, 138493, 131072),
                                   (2048, 50000, 32768)])
def test_bpr_pool_step_v8_kernel(dev, P, U, B, monkeypatch):
    K, wrows = 20, 256
    st, rw, rows, Du, Hp, Di, _, starts, counts = _range_inputs(
        dev, U, K, B, wrows, monkeypatch)
    rng = np.random.default_rng(P)
    pool, rj = _on(dev, rng.integers(0, 500, P), rng.integers(
        0, P, B).astype(np.int32))
    args = (rows, rj, Du, Di, Hp.index_select(0, pool), starts, counts)
    _kernels.reset_launches()
    Aw, Ap, Q = fst.bpr_pool_step_v8(*args, K=K, wd=0.01, rw=rw,
                                     wrows=wrows)
    assert _kernels.launches["bpr_pool_step_v8"] == 1
    Awp, App, Qp = fst.bpr_pool_step_v8_plain(*args, K=K, wd=0.01, rw=rw,
                                              wrows=wrows)
    _close_rows(Q, Qp)
    _close_aw(Aw, Awp, K)
    _close_apool(Ap, App, K)
    assert float(Ap[:, K].sum()) == float(st["mf"].sum())


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("U,wrows,force,want_v", [
    (1500, 256, "", 5), (3000, 512, "", 6), (30000, 256, "7", 7),
    (30000, 256, "", 4), (3000, 512, "pool", 8)])
def test_packed_epochs_on_card_match_cpu(dev, monkeypatch, optimizer, U,
                                         wrows, force, want_v):
    """One epoch of three steps of each pipeline on the card and on the
    CPU (plain versions) from the same state and streams."""
    from cymf_tpu_torch.ops import packed_epoch as tpe
    monkeypatch.setenv("CYMF_TPU_PACKED_KERNEL",
                       "" if force == "pool" else force)
    rng = np.random.default_rng(U + wrows)
    K, I, S, B, lr = 20, 700, 3, 8192, 0.05
    u2 = np.sort(rng.integers(0, U, (S, B)).astype(np.int32), axis=1)
    u2[-1, -500:] = PAD_USER
    i2 = rng.integers(0, I, (S, B)).astype(np.int32)
    rw = pk.packed_rows(U, K, multiple=wrows)
    rh = pk.logical_rows(I, multiple=wrows)
    live = u2 < U
    keys = np.sort(u2[live].astype(np.int64) * I + i2[live])
    kw = dict(opt_name=optimizer, lr=lr, weight_decay=0.01, K=K, rw=rw,
              rh=rh, wrows_w=wrows, wrows_h=wrows)
    if force == "pool":
        winw, si, rowsi, wini = tpe.prep_static_pool(u2, i2, K, rw, rh,
                                                     wrows, wrows)
        pool2, rjs, mask, _ = tpe.prep_pool_epoch(
            np.random.default_rng(1), u2, keys, U, I, 1024)
        streams = (u2, i2, si, rowsi, wini, pool2, rjs, mask, winw)
        fn, name, v = tpe.packed_bpr_pool_epoch, "bpr_pool_step_v8", 8
    else:
        winw, wstart, si, rowsi, wini, bcs, bcn, v = tpe.prep_static(
            u2, i2, K, rw, rh, wrows, wrows)
        j2, mask, sj, rowsj, winj = tpe.prep_epoch(
            np.random.default_rng(1), u2, i2, keys, U, I, K, rh, wrows)
        streams = (u2, i2, si, rowsi, wini, j2, mask, sj, rowsj, winj, winw,
                   wstart, bcs, bcn)
        fn = tpe.packed_bpr_epoch
        kw["kernel_v"] = v
        name = {4: "bpr_sample_phase", 5: "bpr_sample_phase_v5",
                6: "bpr_block_step_v6", 7: "bpr_range_step_v7"}[v]
    assert v == want_v
    W0 = pk.pack_array(rng.normal(size=(U, K)) * 0.1, K, multiple=wrows)
    H0 = pk.pack_logical(rng.normal(size=(I, K)) * 0.1, K, multiple=wrows)
    out = {}
    for d in ("cpu", dev):
        opt = tpe.make_packed_optimizer(optimizer, lr)
        Wp, Hp = _on(d, W0, H0)
        ow, oh = opt.init(Wp), opt.init(Hp)
        _kernels.reset_launches()
        loss = fn(Wp, Hp, ow, oh, *_on(d, *streams), int(live.sum()), **kw)
        out[str(d)] = (Wp.cpu(), Hp.cpu(), float(loss),
                       dict(_kernels.launches))
    (Wc, Hc, lc, nc), (Wg, Hg, lg, ng) = out["cpu"], out[str(dev)]
    assert nc == {} and ng[name] == S
    _close_seq(Wg, Wc, optimizer, lr)
    _close_seq(Hg, Hc, optimizer, lr)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


def test_bpr_fit_on_card_matches_cpu(dev):
    """Two sgd epochs of the whole trainer on the card and on the CPU
    (plain versions) from the same init: equal to summation order.  This
    dense catalog takes pipeline v5 on both."""
    from scipy import sparse

    from cymf_tpu_torch import BPR
    rng = np.random.default_rng(0)
    X = sparse.random(700, 150, density=0.05, random_state=1, format="csr")
    X.data[:] = 1.0
    out = {}
    for d in ("cpu", dev):
        m = BPR(16, learning_rate=0.05, optimizer="sgd", batch_size=2048,
                device=d)
        m.W = rng.uniform(-0.1, 0.1, (700, 16)) if d == "cpu" else out["W0"]
        m.H = np.full((150, 16), 0.01) if d == "cpu" else out["H0"]
        out.setdefault("W0", m.W)
        out.setdefault("H0", m.H)
        np.random.seed(3)
        _kernels.reset_launches()
        m.fit(X, num_epochs=2, verbose=False)
        assert m.packed_kernel_ == 5
        out[str(d)] = (m.W, m.H, m.last_loss, dict(_kernels.launches))
    (Wc, Hc, lc, nc), (Wg, Hg, lg, ng) = out["cpu"], out[str(dev)]
    assert nc == {} and set(ng) == {"bpr_sample_phase_v5", "sorted_accum",
                                    "sorted_accum_dual"}
    np.testing.assert_allclose(Wg, Wc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Hg, Hc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


@pytest.mark.parametrize("K,optimizer", [(160, "sgd"), (160, "adagrad"),
                                         (128, "adam")])
def test_wide_bpr_fit_on_card_matches_cpu(dev, K, optimizer):
    """Two epochs of the wide engine (K >= 128) on the card and on the CPU
    from the same init: equal to summation order under sgd and adagrad;
    under adam fewer than 1% of elements outside that and none off by more
    than 2.5 lr (the first-touch drift class above)."""
    from scipy import sparse

    from cymf_tpu_torch import BPR
    X = sparse.random(700, 300, density=0.05, random_state=1, format="csr")
    X.data[:] = 1.0
    lr = 0.05 if optimizer == "sgd" else 0.01
    out = {}
    for d in ("cpu", dev):
        m = BPR(K, learning_rate=lr, optimizer=optimizer, batch_size=2048,
                device=d)
        np.random.seed(3)
        _kernels.reset_launches()
        m.fit(X, num_epochs=2, verbose=False)
        out[str(d)] = (m.W, m.H, m.last_loss, dict(_kernels.launches))
    (Wc, Hc, lc, nc), (Wg, Hg, lg, ng) = out["cpu"], out[str(dev)]
    steps = 2 * -(-X.nnz // 2048)
    assert nc == {} and ng == {"sorted_accum_wide": steps,
                               "sorted_accum_dual_wide": steps}
    for got, want in ((Wg, Wc), (Hg, Hc)):
        if optimizer == "adam":
            _close_seq(torch.from_numpy(got), torch.from_numpy(want),
                       "adam", lr)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


def _spd(rng, C, B, dev):
    X = torch.from_numpy(rng.standard_normal((C, B, 8)).astype(np.float32))
    return (X @ X.mT / 8 + torch.eye(B)).to(dev)


def _close_chol(L, Linv, Lp):
    torch.cuda.synchronize()
    L, Linv, Lp = L.double(), Linv.double(), Lp.double()
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    assert float((L - Lp).abs().max()) <= 1e-4 * float(Lp.abs().max())
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    assert float((Linv @ Lp - eye).abs().max()) <= 1e-3
    assert (L.triu(1) == 0).all() and (Linv.triu(1) == 0).all()


@pytest.mark.parametrize("B", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("C", [1, 7, 262, 2048])
def test_chol_inv_kernel(dev, C, B):
    A = _spd(np.random.default_rng(C * B), C, B, dev)
    _kernels.reset_launches()
    L, Linv = ck.chol_inv_batched(A, B)
    assert _kernels.launches["chol_inv_batched"] == 1
    _close_chol(L, Linv, ck.chol_inv_batched_plain(A)[0])


def test_chol_inv_kernel_strided_view_and_not_spd(dev):
    big = _spd(np.random.default_rng(1), 300, 256, dev)
    view = big[:, 64:128, 64:128]          # read in place, strided
    L, Linv = ck.chol_inv_batched(view, 64)
    _close_chol(L, Linv, ck.chol_inv_batched_plain(view.contiguous())[0])
    A = _spd(np.random.default_rng(2), 5, 64, dev)
    A[2] = -A[2]
    A[4, 10, 10] = float("nan")
    for what, (L, Linv) in (("kernel", ck.chol_inv_batched(A, 64)),
                            ("plain", ck.chol_inv_batched_plain(A))):
        for c in (2, 4):
            assert torch.isnan(L[c]).all() and torch.isnan(Linv[c]).all(), \
                (what, c)
        assert torch.isfinite(L[[0, 1, 3]]).all(), what


@pytest.mark.parametrize("B", [8, 33, 64, 65, 128])
def test_chol_inv_kernel_not_spd_and_nan_pivot(dev, B):
    """Among C = 262 matrices, one that is not SPD and one whose pivot is
    NaN come out all NaN; the others match plain (both instantiations,
    identity padding at 8, 33 and 65)."""
    A = _spd(np.random.default_rng(B), 262, B, dev)
    A[3] = -A[3]
    A[200, B // 2, B // 2] = float("nan")
    L, Linv = ck.chol_inv_batched(A, B)
    Lp, _ = ck.chol_inv_batched_plain(A)
    for c in (3, 200):
        assert torch.isnan(L[c]).all() and torch.isnan(Linv[c]).all(), c
        assert torch.isnan(Lp[c]).all(), c
    ok = torch.ones(262, dtype=torch.bool, device=dev)
    ok[[3, 200]] = False
    _close_chol(L[ok], Linv[ok], Lp[ok])


def test_chol_inv_raises_on_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="shared memory"):
        ck.chol_inv_batched(torch.eye(160, device=dev).expand(2, -1, -1), 160)
    with pytest.raises(ValueError, match="dtype"):
        ck.chol_inv_batched(torch.eye(64, device=dev, dtype=torch.float64)
                            .expand(2, -1, -1), 64)
    with pytest.raises(ValueError, match="column stride"):
        ck.chol_inv_batched(torch.eye(64, device=dev).expand(2, -1, -1).mT,
                            64)


@pytest.mark.parametrize("model", ["WMF", "ExpoMF"])
def test_als_fit_on_card_matches_cpu(dev, monkeypatch, model):
    """Two epochs at K=128 on the card (kernel diagonal) and on the CPU
    (plain diagonal) from the same init, every WMF chunk in the standard
    form."""
    from scipy import sparse

    import cymf_tpu_torch as ct
    monkeypatch.delenv("CYMF_TPU_ALS_CHOL", raising=False)
    monkeypatch.setenv("CYMF_TPU_ALS_WOODBURY", "off")
    X = sparse.random(500, 300, density=0.06, random_state=4, format="csr",
                      data_rvs=lambda n: np.ones(n))
    out = {}
    for d in ("cpu", dev):
        m = getattr(ct, model)(128, weight_decay=1.0, device=d)
        _kernels.reset_launches()
        m.fit(X, num_epochs=2, verbose=False)
        out[str(d)] = (m.W, m.H, dict(_kernels.launches))
    (Wc, Hc, nc), (Wg, Hg, ng) = out["cpu"], out[str(dev)]
    assert nc == {} and ng.get("chol_inv_batched", 0) > 0
    np.testing.assert_allclose(Wg, Wc, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(Hg, Hc, rtol=2e-3, atol=2e-4)


def test_relmf_fit_on_card_matches_cpu(dev, monkeypatch):
    """Two sgd epochs of RelMF on host prep (one stream for both devices)
    on the card and on the CPU from the same init: equal to summation
    order.  The card's fit launches the sample kernel once a step and the
    accumulation twice."""
    from scipy import sparse

    import cymf_tpu_torch as ct
    monkeypatch.setenv("CYMF_TPU_RELMF_PREP", "host")
    X = sparse.random(300, 200, density=0.06, random_state=2, format="csr")
    X.data[:] = 1.0
    out = {}
    for d in ("cpu", dev):
        m = ct.RelMF(12, learning_rate=0.05, optimizer="sgd",
                     batch_size=4096, device=d)
        _kernels.reset_launches()
        m.fit(X, num_epochs=2, verbose=False, seed=5)
        out[str(d)] = (m.W, m.H, m.last_loss, dict(_kernels.launches))
    (Wc, Hc, lc, nc), (Wg, Hg, lg, ng) = out["cpu"], out[str(dev)]
    steps = 2 * -(-300 * 200 // 4096)
    assert nc == {} and ng == {"glove_sample_phase": steps,
                               "sorted_accum": 2 * steps}
    np.testing.assert_allclose(Wg, Wc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Hg, Hc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


def test_glove_fit_on_card_matches_cpu(dev):
    """Three epochs of GloVe on the card and on the CPU under the same
    ``np.random.seed``: equal to summation order, constant columns exactly
    one on both."""
    from scipy import sparse

    import cymf_tpu_torch as ct
    rng = np.random.default_rng(3)
    dense = np.where(rng.random((400, 400)) < 0.05,
                     rng.integers(1, 60, (400, 400)), 0).astype(np.float64)
    X = sparse.csr_matrix(dense)
    out = {}
    for d in ("cpu", dev):
        np.random.seed(11)
        m = ct.GloVe(num_components=20, batch_size=2048, device=d)
        _kernels.reset_launches()
        m.fit(X, num_epochs=3)
        out[str(d)] = (m.W, m.bias, m.context_bias, m.last_loss,
                       dict(_kernels.launches))
        assert all((c == 1).all() for c in m.constant_columns_)
    (*tc, lc, nc), (*tg, lg, ng) = out["cpu"], out[str(dev)]
    assert nc == {} and set(ng) == {"glove_sample_phase", "sorted_accum"}
    for g, c in zip(tg, tc):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


def _close_seq(got, want, optimizer, lr):
    """The sequential epochs' table tolerance (module docstring)."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.double() - want.double()).abs()
    bad = err > 1e-5 + 1e-4 * want.double().abs()
    if optimizer != "adam":
        assert not bad.any(), float(err.max())
        return
    assert int(bad.sum()) < 0.01 * got.numel(), int(bad.sum())
    assert float(err.max()) <= 2.5 * lr


def _seq_streams(rng, rows_a, rows_b, S, chunk, n_idx, dev):
    n = S * chunk
    a = rng.integers(0, rows_a, n)
    idx = [a] + [rng.integers(0, rows_b, n) for _ in range(n_idx - 1)]
    keep = rng.random(n) > 0.1
    if n_idx == 3:
        keep &= idx[1] != idx[2]      # a kept BPR sample has i != j
    return [torch.from_numpy(x.astype(np.int32).reshape(S, 1, chunk)).to(dev)
            for x in idx + [keep]]


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("I,S,chunk", [(200, 4, 256), (3, 3, 32)])
def test_bpr_seq_epoch_kernel(dev, optimizer, group, I, S, chunk):
    """Against the plain version; a 3-item catalog makes rows collide
    inside a group, which pins the later-write-wins order."""
    rng = np.random.default_rng(I + group)
    u, i, j, mask = _seq_streams(rng, 300, I, S, chunk, 3, dev)
    W0 = pe.pack_table(rng.normal(size=(300, 20)) * 0.1, optimizer, dev)
    H0 = pe.pack_table(rng.normal(size=(I, 20)) * 0.1, optimizer, dev)
    kw = dict(optimizer=optimizer, lr=0.05, wd=0.01, group=group)
    _kernels.reset_launches()
    W, H, loss = pe.bpr_pallas_epoch(W0.clone(), H0.clone(), u, i, j, mask,
                                     **kw)
    assert _kernels.launches["bpr_pallas_epoch"] == 1
    Wp, Hp, lossp = pe.bpr_pallas_epoch_plain(W0.clone(), H0.clone(), u, i,
                                              j, mask, **kw)
    _close_seq(W, Wp, optimizer, 0.05)
    _close_seq(H, Hp, optimizer, 0.05)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)
    W2, H2, _ = pe.bpr_pallas_epoch(W0.clone(), H0.clone(), u, i, j, mask,
                                    **kw)
    assert torch.equal(W, W2) and torch.equal(H, H2)    # deterministic


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("I,S,chunk", [(200, 4, 256), (3, 3, 32)])
def test_relmf_seq_epoch_kernel(dev, optimizer, group, I, S, chunk):
    rng = np.random.default_rng(2 * I + group)
    u, i, mask = _seq_streams(rng, 300, I, S, chunk, 2, dev)
    w = torch.from_numpy(((rng.random(S * chunk) < 0.3)
                          * rng.uniform(1, 5, S * chunk)).astype(np.float32)
                         .reshape(S, 1, chunk)).to(dev)
    W0 = pe.pack_table(rng.normal(size=(300, 12)) * 0.1, optimizer, dev)
    H0 = pe.pack_table(rng.normal(size=(I, 12)) * 0.1, optimizer, dev)
    kw = dict(optimizer=optimizer, lr=0.02, wd=0.01, group=group)
    _kernels.reset_launches()
    W, H, loss = pe.relmf_pallas_epoch(W0.clone(), H0.clone(), u, i, w, mask,
                                       **kw)
    assert _kernels.launches["relmf_pallas_epoch"] == 1
    Wp, Hp, lossp = pe.relmf_pallas_epoch_plain(W0.clone(), H0.clone(), u, i,
                                                w, mask, **kw)
    _close_seq(W, Wp, optimizer, 0.02)
    _close_seq(H, Hp, optimizer, 0.02)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("V,S,chunk", [(500, 4, 256), (3, 3, 32)])
def test_glove_seq_epoch_kernel(dev, group, V, S, chunk):
    """Against the plain version; the constant-one columns stay exactly
    one."""
    from cymf_tpu_torch.ops.glove_epoch import augment_tables
    rng = np.random.default_rng(V + group)
    K = 50
    c, x, mask = _seq_streams(rng, V, V, S, chunk, 2, dev)
    cnt = rng.integers(1, 50, S * chunk).astype(np.float64)
    f = torch.from_numpy(np.minimum((cnt / 10) ** 0.75, 1.0).astype(
        np.float32).reshape(S, 1, chunk)).to(dev)
    lc = torch.from_numpy(np.log(cnt).astype(np.float32).reshape(
        S, 1, chunk)).to(dev)
    Zc, Zx = augment_tables(*(rng.uniform(-0.5, 0.5, shape) / K for shape in
                              ((V, K), (V,), (V, K), (V,))))
    Zc0 = pe.pack_table(Zc, "adagrad", dev)
    Zx0 = pe.pack_table(Zx, "adagrad", dev)
    _kernels.reset_launches()
    A, B, loss = pe.glove_pallas_epoch(Zc0.clone(), Zx0.clone(), c, x, f, lc,
                                       mask, lr=0.05, k_dim=K, group=group)
    assert _kernels.launches["glove_pallas_epoch"] == 1
    Ap, Bp, lossp = pe.glove_pallas_epoch_plain(
        Zc0.clone(), Zx0.clone(), c, x, f, lc, mask, lr=0.05, k_dim=K,
        group=group)
    _close_seq(A, Ap, "adagrad", 0.05)
    _close_seq(B, Bp, "adagrad", 0.05)
    torch.testing.assert_close(loss, lossp, rtol=1e-5, atol=0.0)
    assert (A[:, K + 1] == 1).all() and (B[:, K] == 1).all()


def test_seq_epoch_raises_on_what_it_does_not_take(dev):
    W = pe.pack_table(np.zeros((10, 8)), "sgd", dev)
    idx = torch.zeros((1, 1, 32), dtype=torch.int32, device=dev)
    kw = dict(optimizer="sgd", lr=0.1, wd=0.0)
    with pytest.raises(ValueError, match="group"):
        pe.bpr_pallas_epoch(W, W.clone(), idx, idx, idx, idx, group=32, **kw)
    with pytest.raises(ValueError, match="dtype"):
        pe.bpr_pallas_epoch(W, W.clone(), idx.long(), idx.long(), idx.long(),
                            idx.long(), **kw)
    with pytest.raises(ValueError, match="on cpu"):
        pe.bpr_pallas_epoch(W, W.clone(), idx.cpu(), idx, idx, idx, **kw)
    with pytest.raises(ValueError, match="tables are on"):
        pe.bpr_pallas_epoch(W, W.cpu(), idx, idx, idx, idx, **kw)


# the sequential kernels' placements: device memory, the block's shared
# memory
SEQ_PLACEMENTS = [0, 1]
SEQ_MODELS = [("bpr", o) for o in ("sgd", "adagrad", "adam")] + [
    ("relmf", o) for o in ("sgd", "adagrad", "adam")] + [("glove", "adagrad")]


def _seq_case(model, optimizer, rows, group, dev, S=3, K=None, rows_a=300):
    """``(wrapper, plain, tables, streams, kw)`` of a small launch whose
    tables hold ``rows`` rows each (3: rows collide in every group; BPR and
    RelMF's W ``rows_a``), in chunks of 64 (every group size divides it);
    ``K`` the payload width (20; GloVe's ``k_dim`` 50)."""
    rng = np.random.default_rng(rows * 31 + group)
    chunk = 64
    if model == "glove":
        from cymf_tpu_torch.ops.glove_epoch import augment_tables
        K = K or 50
        c, x, mask = _seq_streams(rng, rows, rows, S, chunk, 2, dev)
        cnt = rng.integers(1, 50, S * chunk).astype(np.float64)
        f = torch.from_numpy(np.minimum((cnt / 10) ** 0.75, 1.0).astype(
            np.float32).reshape(S, 1, chunk)).to(dev)
        lc = torch.from_numpy(np.log(cnt).astype(np.float32).reshape(
            S, 1, chunk)).to(dev)
        Zc, Zx = augment_tables(*(rng.uniform(-0.5, 0.5, shape) / K for shape
                                  in ((rows, K), (rows,), (rows, K),
                                      (rows,))))
        tables = [pe.pack_table(Z, "adagrad", dev) for Z in (Zc, Zx)]
        return (pe.glove_pallas_epoch, pe.glove_pallas_epoch_plain, tables,
                [c, x, f, lc, mask], dict(lr=0.05, k_dim=K, group=group))
    n_idx = 3 if model == "bpr" else 2
    streams = _seq_streams(rng, rows_a, rows, S, chunk, n_idx, dev)
    if model == "relmf":
        w = torch.from_numpy(((rng.random(S * chunk) < 0.3)
                              * rng.uniform(1, 5, S * chunk)).astype(
                                  np.float32).reshape(S, 1, chunk)).to(dev)
        streams = streams[:2] + [w, streams[2]]
    tables = [pe.pack_table(rng.normal(size=(r, K or 20)) * 0.1, optimizer,
                            dev) for r in (rows_a, rows)]
    fns = {"bpr": (pe.bpr_pallas_epoch, pe.bpr_pallas_epoch_plain),
           "relmf": (pe.relmf_pallas_epoch, pe.relmf_pallas_epoch_plain)}
    return (*fns[model], tables, streams,
            dict(optimizer=optimizer, lr=0.05, wd=0.01, group=group))


@pytest.mark.parametrize("placement", SEQ_PLACEMENTS)
@pytest.mark.parametrize("group", [1, 8, 16])
@pytest.mark.parametrize("rows", [3, 200])
@pytest.mark.parametrize("model,optimizer", SEQ_MODELS)
def test_seq_epoch_placement(dev, model, optimizer, rows, group, placement):
    """Each placement, forced, against the plain version; the 3-row
    catalog makes rows collide in every group, so one group's stores are
    read by the next."""
    fn, plain, tables, streams, kw = _seq_case(model, optimizer, rows, group,
                                               dev)
    _kernels.reset_launches()
    got = fn(*(t.clone() for t in tables), *streams, _placement=placement,
             **kw)
    assert sum(_kernels.launches.values()) == 1
    want = plain(*(t.clone() for t in tables), *streams, **kw)
    for g, w in zip(got[:2], want[:2]):
        _close_seq(g, w, optimizer, kw["lr"])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0)
    if model == "glove":
        assert (got[0][:, 51] == 1).all() and (got[1][:, 50] == 1).all()


@pytest.mark.parametrize("placement", SEQ_PLACEMENTS)
@pytest.mark.parametrize("K", [30, 34, 62, 66, 126])
@pytest.mark.parametrize("model,optimizer", SEQ_MODELS)
def test_seq_epoch_column_widths(dev, model, optimizer, K, placement):
    """One, two and four columns a lane: segment widths on each side of
    the kernel's edges (32 | 36, 64 | 68) and the widest, 128 (GloVe's
    ``k_dim`` K - 2 gives the same widths), at both placements, against
    the plain version on a colliding 3-row catalog."""
    k = K - 2 if model == "glove" else K
    fn, plain, tables, streams, kw = _seq_case(model, optimizer, 3, 8, dev,
                                               K=k, rows_a=50)
    assert tables[0].shape[1] % pe.segment_width(K) == 0
    got = fn(*(t.clone() for t in tables), *streams, _placement=placement,
             **kw)
    want = plain(*(t.clone() for t in tables), *streams, **kw)
    for g, w in zip(got[:2], want[:2]):
        _close_seq(g, w, optimizer, kw["lr"])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0)
    if model == "glove":
        assert (got[0][:, k + 1] == 1).all() and (got[1][:, k] == 1).all()


@pytest.mark.parametrize("group", [1, 8, 16])
@pytest.mark.parametrize("model,optimizer", SEQ_MODELS)
def test_seq_epoch_placements_bit_identical(dev, model, optimizer, group):
    """Both placements compute the same bits (only where a row lives
    differs), and two calls of the planned one do too."""
    for rows in (3, 200):
        fn, _, tables, streams, kw = _seq_case(model, optimizer, rows, group,
                                               dev)
        outs = [fn(*(t.clone() for t in tables), *streams, _placement=p,
                   **kw) for p in SEQ_PLACEMENTS + [None, None]]
        torch.cuda.synchronize()
        for o in outs[1:]:
            for g, w in zip(o, outs[0]):
                assert torch.equal(g, w)


def test_seq_glove_over_block_capacity(dev):
    """GloVe tables over the block's shared memory (the 5,000-word GloVe
    of ``chip_smoke.py`` is too) stay in device memory, match plain there
    over many staged slices, and forcing them into the block raises."""
    V = 4000
    row_bytes = 2 * pe.segment_width(52) * 4
    assert 2 * V * row_bytes > pe.TABLE_BYTES
    assert pe.seq_placement(V, V, row_bytes) == 0
    assert _kernels.lib().cymf_seq_epoch_plan(V, V, row_bytes) == 0
    fn, plain, tables, streams, kw = _seq_case("glove", "adagrad", V, 8, dev,
                                               S=40)
    got = fn(*(t.clone() for t in tables), *streams, **kw)
    want = plain(*(t.clone() for t in tables), *streams, **kw)
    for g, w in zip(got[:2], want[:2]):
        _close_seq(g, w, "adagrad", kw["lr"])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0)
    with pytest.raises(RuntimeError, match="glove_pallas_epoch"):
        fn(*(t.clone() for t in tables), *streams, _placement=1, **kw)


def _plan_edges():
    """(rows_a, rows_b, row_bytes) at the chip_smoke shapes, and one row
    under and over the block's capacity at three row widths and table
    ratios."""
    shapes = [(943, 1682, 240), (5000, 5000, 416), (600, 300, 240),
              (300, 3, 240), (0, 0, 240)]
    for rb, ratio in ((240, 1), (416, 2), (80, 3)):
        r = pe.TABLE_BYTES // rb // (ratio + 1)
        assert (ratio + 1) * r * rb <= pe.TABLE_BYTES
        assert (ratio + 1) * (r + 1) * rb > pe.TABLE_BYTES
        shapes += [(ratio * r, r, rb), (ratio * r + 1, r, rb),
                   (ratio * (r + 1), r + 1, rb)]
    return shapes


@pytest.mark.parametrize("rows_a,rows_b,row_bytes", _plan_edges())
def test_seq_plan_matches_mirror(dev, rows_a, rows_b, row_bytes):
    got = _kernels.lib().cymf_seq_epoch_plan(rows_a, rows_b, row_bytes)
    assert got == pe.seq_placement(rows_a, rows_b, row_bytes)


@pytest.mark.parametrize("model", ["bpr", "relmf", "glove"])
def test_seq_refused_placement_raises(dev, model):
    """A placement the kernel refuses raises, and nothing runs in its
    place: tables over the block's shared memory forced into it (the
    ml-100k tables of ``chip_smoke.py``), and a placement that does not
    exist (the C entries read -1 as the plan's)."""
    fn, _, tables, streams, kw = _seq_case(model, "adam", 200, 8, dev)
    if model == "glove":
        big = [pe.pack_table(np.ones((300, 52)), "adagrad", dev)] * 2
    else:
        big = [pe.pack_table(np.zeros((r, 20)), "adam", dev)
               for r in (943, 1682)]
    assert pe.seq_placement(big[0].shape[0], big[1].shape[0],
                            big[0].shape[1] * 4) == 0
    name = fn.__name__
    for t, p in ((big, 1), (tables, 2), (tables, -2)):
        _kernels.reset_launches()
        with pytest.raises(RuntimeError, match=name):
            fn(*(x.clone() for x in t), *streams, _placement=p, **kw)
        assert not _kernels.launches
