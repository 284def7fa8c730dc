"""The port's sorted accumulation against the JAX package's.

Host helpers (window ranges, padding) must be bit-equal.  The plain
PyTorch versions of the two accumulation kernels must match the Pallas
kernels run in interpret mode with ``precision="highest"`` to
``rtol 2e-5, atol 2e-6``: both sum float32 rows, in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import sorted_accum as jsa
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import sorted_accum as tsa

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
