"""The port's sorted accumulation against the JAX package's.

Host helpers (window ranges, padding) must be bit-equal.  The plain
PyTorch versions of the two accumulation kernels must match the Pallas
kernels run in interpret mode with ``precision="highest"`` to
``rtol 2e-5, atol 2e-6``: both sum float32 rows, in different orders.
The single-stream kernel's partition (``segment_twin``, its Python twin)
must sum every live sample once and write every output row once, on the
adversarial streams the card tests run the kernel on, at the kernel's part
and gap sizes and at others.  The dual kernel's (``dual_twin``) must, on
pairs of those streams, sum every live sample of each stream once into its
own row, write every row once in the j pass and add at most one run sum
of the i stream to a row; its sums
must match the plain version and the JAX kernel in interpret mode to
``rtol 1e-4`` and ``1e-5`` of the output's max absolute (float32 sums of
up to ~2,000 samples a row in other orders: where a row's sum cancels,
two orders differ by ~3e-5 of a max of ~50), the counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import sorted_accum as jsa
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import sorted_accum as tsa
# the streams the card tests run the single-stream kernel on, and the
# pairs of them they run the dual kernel on
from test_torch_cuda_kernels import (DUAL_PAIRS, SEGMENT_STREAMS,
                                     dual_streams, segment_streams)

RTOL, ATOL = 2e-5, 2e-6


def _stream(rng, B, R, lo=0, hi=None, pad_to=1024, sentinel=None):
    """Sorted rows in [lo, hi) padded with a sentinel >= R to a tile
    multiple, plus matching gradient rows."""
    hi = R if hi is None else hi
    rows = np.sort(rng.integers(lo, hi, B)).astype(np.int32)
    rows2d = jsa.pad_samples(rows, R if sentinel is None else sentinel,
                             tile=pad_to)
    g = rng.normal(size=(rows2d.size, 128)).astype(np.float32)
    return rows, rows2d, g


@pytest.mark.parametrize("n,R,wrows,tile,align", [
    (3000, 1024, 256, 1024, 128),
    (500, 2048, 512, 1024, None),
    (10000, 512, 128, 1024, 128),
    (1, 256, 256, 1024, 128),
    (0, 256, 128, 1024, 128),
    (4096, 768, 256, 2048, 256),
])
def test_window_ranges_bit_equal(n, R, wrows, tile, align):
    rng = np.random.default_rng(n + R)
    rows = np.sort(rng.integers(0, R, n)).astype(np.int64)
    got = tsa.window_ranges(rows, R, wrows, tile, align=align)
    want = jsa.window_ranges(rows, R, wrows, tile, align=align)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,tile", [(3000, 1024), (1, 128), (0, 1024),
                                    (2048, 1024)])
def test_pad_samples_bit_equal(n, tile):
    rows = np.arange(n, dtype=np.int32)
    got = tsa.pad_samples(rows, 7777, tile)
    want = jsa.pad_samples(rows, 7777, tile)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _jax_accum(rows2d, g, starts, counts, R, wrows):
    return np.asarray(jsa.sorted_accum(
        jnp.asarray(rows2d), jnp.asarray(g), jnp.asarray(starts),
        jnp.asarray(counts), r_pad=R, wrows=wrows, interpret=True,
        precision="highest"))


@pytest.mark.parametrize("B,R,wrows,hi", [
    (3000, 1024, 256, None),
    (1024, 512, 128, 100),       # every sample in one window
    (2048, 2048, 256, 2040),     # windows past the last row stay zero
    (0, 256, 128, None),         # empty input
])
def test_sorted_accum_plain_matches_jax(B, R, wrows, hi):
    rng = np.random.default_rng(B + R)
    _, rows2d, g = _stream(rng, B, R, hi=hi)
    rows_s = rows2d.reshape(-1)[:B]
    starts, counts = tsa.window_ranges(rows_s, R, wrows, 1024, align=128)
    want = _jax_accum(rows2d, g, starts, counts, R, wrows)
    _kernels.reset_launches()
    got = tsa.sorted_accum(torch.from_numpy(rows2d), torch.from_numpy(g),
                           torch.from_numpy(starts),
                           torch.from_numpy(counts), r_pad=R, wrows=wrows)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert _kernels.launches["sorted_accum"] == 0


def test_sorted_accum_reanchored_windows():
    """align=128 windows whose last tile would overrun the padded length
    are re-anchored earlier; samples of the previous window they sweep in
    must not be counted twice."""
    rng = np.random.default_rng(5)
    B, R, wrows = 3000, 512, 128
    rows = np.sort(np.concatenate([rng.integers(0, 128, B - 50),
                                   rng.integers(384, 512, 50)]))
    rows2d = jsa.pad_samples(rows.astype(np.int32), R)
    g = rng.normal(size=(rows2d.size, 128)).astype(np.float32)
    starts, counts = tsa.window_ranges(rows, R, wrows, 1024, align=128)
    edges = np.searchsorted(rows, np.arange(R // wrows) * wrows)
    assert (starts < (edges // 128) * 128).any()   # some were re-anchored
    want = _jax_accum(rows2d, g, starts, counts, R, wrows)
    got = tsa.sorted_accum(torch.from_numpy(rows2d), torch.from_numpy(g),
                           torch.from_numpy(starts),
                           torch.from_numpy(counts), r_pad=R, wrows=wrows)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Bi,Bj,R,wrows,neg_lanes", [
    (2048, 2048, 512, 256, 20),
    (3000, 1024, 1024, 128, 33),
    (0, 1024, 256, 128, 64),     # empty i stream
    (1024, 0, 256, 128, 100),    # empty j stream
])
def test_sorted_accum_dual_plain_matches_jax(Bi, Bj, R, wrows, neg_lanes):
    rng = np.random.default_rng(Bi * 7 + Bj)
    _, ri2d, gi = _stream(rng, Bi, R)
    _, rj2d, gj = _stream(rng, Bj, R)
    si, ci = tsa.window_ranges(ri2d.reshape(-1)[:Bi], R, wrows, 1024,
                               align=128)
    sj, cj = tsa.window_ranges(rj2d.reshape(-1)[:Bj], R, wrows, 1024,
                               align=128)
    want = np.asarray(jsa.sorted_accum_dual(
        *(jnp.asarray(a) for a in (ri2d, gi, si, ci, rj2d, gj, sj, cj)),
        r_pad=R, neg_lanes=neg_lanes, wrows=wrows, interpret=True,
        precision="highest"))
    _kernels.reset_launches()
    got = tsa.sorted_accum_dual(
        *(torch.from_numpy(a) for a in (ri2d, gi, si, ci, rj2d, gj, sj,
                                        cj)),
        r_pad=R, neg_lanes=neg_lanes, wrows=wrows)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert _kernels.launches["sorted_accum_dual"] == 0


def test_wrapper_rejects_bad_arguments():
    g = torch.zeros(1024, 128)
    rows = torch.zeros(1024, dtype=torch.int32)
    win = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of wrows"):
        tsa.sorted_accum(rows, g, win, win, r_pad=500, wrows=128)
    with pytest.raises(ValueError, match="row ids"):
        tsa.sorted_accum(rows[:100], g, win, win, r_pad=512, wrows=128)
    with pytest.raises(ValueError, match="widths"):
        tsa.sorted_accum_dual(rows, g, win, win, rows, g[:, :64], win, win,
                              r_pad=512, neg_lanes=8, wrows=128)


def _masked_stream(rng, B, R, width, live=0.8):
    """A sorted stream with its dead samples routed to the sentinel R (as
    the wide engine routes them), padded to a tile multiple."""
    rows = np.sort(rng.integers(0, R, B)).astype(np.int32)
    rows2d = tsa.pad_samples(np.where(rng.random(B) < live, rows, R)
                             .astype(np.int32), R)
    g = rng.normal(size=(rows2d.size, width)).astype(np.float32)
    return rows, rows2d, g


def _check_count_lanes(got, want, width):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :width], want[:, :width], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[:, width], want[:, width])  # counts
    assert not got[:, width + 1:].any()                         # unused


@pytest.mark.parametrize("width", [128, 256, 384])
@pytest.mark.parametrize("B,R,wrows", [(3000, 1024, 256), (2048, 512, 128),
                                       (0, 256, 128)])
def test_sorted_accum_count_lanes_plain_matches_jax(width, B, R, wrows):
    """``count_lanes=True``: the payload of the live samples on lanes
    ``[0, width)``, their count per row on lane ``width`` (exact), zeros
    on the other 127 lanes; dead samples sit at the sentinel row R."""
    rng = np.random.default_rng(B + R + width)
    rows, rows2d, g = _masked_stream(rng, B, R, width)
    starts, counts = tsa.window_ranges(rows, R, wrows, 1024, align=128)
    want = np.asarray(jsa.sorted_accum(
        jnp.asarray(rows2d), jnp.asarray(g), jnp.asarray(starts),
        jnp.asarray(counts), r_pad=R, wrows=wrows, interpret=True,
        precision="highest", count_lanes=True))
    _kernels.reset_launches()
    got = tsa.sorted_accum(torch.from_numpy(rows2d), torch.from_numpy(g),
                           torch.from_numpy(starts),
                           torch.from_numpy(counts), r_pad=R, wrows=wrows,
                           count_lanes=True)
    assert got.shape == (R, width + 128)
    _check_count_lanes(got.numpy(), want, width)
    live = rows2d.reshape(-1)[:B] < R
    assert got[:, width].sum() == live.sum()
    assert not _kernels.launches


@pytest.mark.parametrize("width", [128, 256, 384])
@pytest.mark.parametrize("Bi,Bj,R,wrows", [(2048, 3000, 512, 128),
                                           (1024, 0, 1024, 256)])
def test_sorted_accum_dual_count_lanes_plain_matches_jax(width, Bi, Bj, R,
                                                         wrows):
    """The dual form's counts add both streams; the i stream's payload is
    negated on every payload lane (``neg_lanes = width``, the wide
    engine's H side)."""
    rng = np.random.default_rng(Bi + Bj + width)
    args = []
    for n in (Bi, Bj):
        rows, rows2d, g = _masked_stream(rng, n, R, width)
        args += [rows2d, g, *tsa.window_ranges(rows, R, wrows, 1024,
                                               align=128)]
    want = np.asarray(jsa.sorted_accum_dual(
        *(jnp.asarray(a) for a in args), r_pad=R, neg_lanes=width,
        wrows=wrows, interpret=True, precision="highest",
        count_lanes=True))
    got = tsa.sorted_accum_dual(*(torch.from_numpy(a) for a in args),
                                r_pad=R, neg_lanes=width, wrows=wrows,
                                count_lanes=True)
    _check_count_lanes(got.numpy(), want, width)


def test_wide_widths_without_count_lanes_match_jax():
    rng = np.random.default_rng(8)
    B, R, wrows, width = 3000, 1024, 256, 256
    _, rows2d, g = _stream(rng, B, R)
    g = np.concatenate([g, g[:, ::-1]], axis=1)
    starts, counts = tsa.window_ranges(rows2d.reshape(-1)[:B], R, wrows,
                                       1024, align=128)
    want = _jax_accum(rows2d, np.ascontiguousarray(g), starts, counts, R,
                      wrows)
    got = tsa.sorted_accum(torch.from_numpy(rows2d),
                           torch.from_numpy(np.ascontiguousarray(g)),
                           torch.from_numpy(starts),
                           torch.from_numpy(counts), r_pad=R, wrows=wrows)
    assert got.shape == (R, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_width_not_a_multiple_of_128_raises():
    rows = torch.zeros(1024, dtype=torch.int32)
    win = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tsa.sorted_accum(rows, torch.zeros(1024, 200), win, win, r_pad=512,
                         wrows=128, count_lanes=True)


# the kernel's parts of 64 samples and gaps of at most 32 rows zeroed by a
# part (csrc/sorted_accum.cu::PART, ZERO_GAP), and other sizes
@pytest.mark.parametrize("zero_gap", [0, 32])
@pytest.mark.parametrize("part", [32, 64, 100])
@pytest.mark.parametrize("stream", SEGMENT_STREAMS)
def test_segment_twin_owns_each_sample_once(stream, part, zero_gap):
    """Every live sample is summed exactly once, into its own row; no dead
    sample is; every row in [0, r_pad) is written exactly once (a run's
    sum, a part's gap or the zero fill)."""
    R = 4096
    rows = segment_streams(R)[stream]
    t = tsa.segment_twin(rows, R, part, zero_gap)
    live = (rows >= 0) & (rows < R)
    assert t["parts"] == -(-rows.size // part)
    np.testing.assert_array_equal(t["writes"], np.ones(R))
    np.testing.assert_array_equal(t["carried"], live)
    np.testing.assert_array_equal(t["into"][live], rows[live])
    assert t["runs"] == np.unique(rows[live]).size
    if stream == "power-law":          # the first 256-row window's share
        assert (rows < 256).mean() >= 0.25
    if stream == "long-run":           # one run over more parts than a CTA
        assert t["longest"] == 3000
        assert t["walk"] >= 3000 // part - 1


def test_segment_twin_refuses_decreasing_live_rows():
    R = 64
    tsa.segment_twin(np.array([5, R, 6, -1, 7, 900, 7]), R, 2, 32)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsa.segment_twin(np.array([5, R, 4]), R, 2, 32)


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("stream", SEGMENT_STREAMS)
def test_sorted_accum_plain_on_segment_streams(stream, count):
    """The CPU path on interleaved, negative and tail sentinels: a float64
    scatter of the live samples, within 1e-5 of its max (float32 sums of
    up to 3,000 samples a row), the counts exact."""
    R, width = 4096, 128
    rows = segment_streams(R)[stream]
    g = np.random.default_rng(3).normal(size=(rows.size, width)).astype(
        np.float32)
    win = torch.zeros(R // 512, dtype=torch.int32)
    got = tsa.sorted_accum(torch.from_numpy(rows), torch.from_numpy(g), win,
                           win, r_pad=R, wrows=512, count_lanes=count)
    live = (rows >= 0) & (rows < R)
    want = np.zeros((R, width + 128 if count else width))
    np.add.at(want[:, :width], rows[live], g[live].astype(np.float64))
    if count:
        want[:, width] = np.bincount(rows[live], minlength=R)
    got = got.numpy()
    np.testing.assert_allclose(got[:, :width], want[:, :width], rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))
    np.testing.assert_array_equal(got[:, width:], want[:, width:])


@pytest.mark.parametrize("stream", SEGMENT_STREAMS)
def test_segment_twin_sums_match_plain(stream):
    """The twin's run sums, formed in the kernel's order, are the plain
    scatter's to float32 round-off."""
    R = 4096
    rows = segment_streams(R)[stream]
    g = np.random.default_rng(4).normal(size=(rows.size, 128)).astype(
        np.float32)
    t = tsa.segment_twin(rows, R, 64, 32, g=g)
    win = torch.zeros(R // 512, dtype=torch.int32)
    want = tsa.sorted_accum_plain(torch.from_numpy(rows), torch.from_numpy(g),
                                  win, win, r_pad=R, wrows=512)
    np.testing.assert_allclose(t["sums"], want.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("zero_gap", [0, 32])
@pytest.mark.parametrize("part", [64, 100])
@pytest.mark.parametrize("pair", DUAL_PAIRS, ids="+".join)
def test_dual_twin_owns_each_sample_once(pair, part, zero_gap):
    """Every live sample of each stream is summed exactly once, into its
    own row, no dead sample is; the j pass writes every row exactly once
    (a run sum, a gap or the zero fill), and the i pass adds one run sum
    to each row that has an i sample on it and none to the others."""
    R = 4096
    streams = dual_streams(pair, R)
    g = [np.ones((r.size, 128), np.float32) for r in streams]
    t = tsa.dual_twin(streams[0], g[0], streams[1], g[1], R, part,
                      zero_gap, 20)
    assert t["parts_i"] == -(-streams[0].size // part)
    assert t["parts_j"] == -(-streams[1].size // part)
    np.testing.assert_array_equal(t["stores"], np.ones(R))
    live_i = (streams[0] >= 0) & (streams[0] < R)
    np.testing.assert_array_equal(
        t["adds"], np.bincount(streams[0][live_i], minlength=R) > 0)
    for rows, tw in zip(streams, (t["i"], t["j"])):
        live = (rows >= 0) & (rows < R)
        np.testing.assert_array_equal(tw["carried"], live)
        np.testing.assert_array_equal(tw["into"][live], rows[live])
        assert tw["runs"] == np.unique(rows[live]).size


def _monotone(rows, R):
    """A non-decreasing stand-in of a stream whose sentinels sit anywhere:
    each sentinel takes the last live row before it, so that
    :func:`window_ranges` over it covers every live sample of a window."""
    live = (rows >= 0) & (rows < R)
    return np.maximum(np.maximum.accumulate(np.where(live, rows, -1)), 0)


def _jax_dual_on(streams, g, R, wrows, neg_lanes, count_lanes):
    """The JAX dual kernel in interpret mode on streams whose sentinels sit
    anywhere: each padded to a tile multiple (sentinel R, zero rows), its
    window ranges taken over :func:`_monotone`."""
    args = []
    for rows, x in zip(streams, g):
        rows2d = jsa.pad_samples(rows, R)
        xp = np.zeros((rows2d.size, x.shape[1]), np.float32)
        xp[:rows.size] = x
        args += [rows2d, xp, *jsa.window_ranges(_monotone(rows, R), R, wrows,
                                                1024, align=128)]
    return np.asarray(jsa.sorted_accum_dual(
        *(jnp.asarray(a) for a in args), r_pad=R, neg_lanes=neg_lanes,
        wrows=wrows, interpret=True, precision="highest",
        count_lanes=count_lanes))


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("pair", DUAL_PAIRS, ids="+".join)
def test_dual_twin_matches_plain_and_jax(pair, count):
    """The twin's output (the kernel's partition, sums and meet rule)
    against the plain version and the JAX kernel on the same numpy
    inputs: width 128 with 20 negated lanes (the packed H side), or width
    256 with every payload lane negated and the count granule (the wide
    engine's)."""
    R, wrows = 4096, 512
    width, neg = (256, 256) if count else (128, 20)
    streams = dual_streams(pair, R)
    rng = np.random.default_rng(len(pair[0]) + 7 * len(pair[1]))
    g = [rng.normal(size=(r.size, width)).astype(np.float32)
         for r in streams]
    t = tsa.dual_twin(streams[0], g[0], streams[1], g[1], R, 64, 32, neg,
                      count_lanes=count)
    win = torch.zeros(R // wrows, dtype=torch.int32)
    plain = tsa.sorted_accum_dual(
        torch.from_numpy(streams[0]), torch.from_numpy(g[0]), win, win,
        torch.from_numpy(streams[1]), torch.from_numpy(g[1]), win, win,
        r_pad=R, neg_lanes=neg, wrows=wrows, count_lanes=count).numpy()
    want = _jax_dual_on(streams, g, R, wrows, neg, count)
    for ref in (plain, want):
        assert t["out"].shape == ref.shape
        scale = max(float(np.abs(ref[:, :width]).max(initial=0)), 1.0)
        np.testing.assert_allclose(t["out"][:, :width], ref[:, :width],
                                   rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_array_equal(t["out"][:, width:], ref[:, width:])
    if pair == ("all-sentinels", "all-sentinels"):
        assert not t["out"].any()
