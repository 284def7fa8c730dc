"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes and edge cases (tails, empty streams, one-row
runs across warps, re-anchored windows, every slot count).

Needs an NVIDIA GPU; skips without one.  This file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: sample-phase outputs ``rtol 1e-5, atol 1e-6`` and the loss
relative ``1e-5`` (row sums reduce in another order); accumulations
``1e-5 * max|plain|`` absolute (summation order, atomics); the batched
Cholesky ``|dL| <= 1e-4 max|L|`` and ``|Linv L - I| <= 1e-3``, the JAX
package's own bounds for its kernel; ALS fits ``rtol 2e-3, atol 2e-4``,
its bound between solver forms.
"""

import numpy as np
import pytest
import torch

from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import chol_kernel as ck
from cymf_tpu_torch.ops import fused_sample as fs
from cymf_tpu_torch.ops import packed as pk
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


@pytest.mark.parametrize("B,R,wrows,lo,hi", [
    (3000, 1024, 256, 0, None),
    (4096, 512, 128, 100, 103),     # three rows: runs span every warp
    (2048, 2048, 256, 0, 300),      # most windows empty
    (0, 256, 128, 0, None),         # empty stream
    (10000, 512, 128, 0, None),
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


def test_wrappers_raise_on_what_kernels_do_not_take(dev):
    g = torch.zeros(1024, 128, device=dev)
    rows = torch.zeros(1024, dtype=torch.int32, device=dev)
    win = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        sa.sorted_accum(rows.long(), g, win, win, r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="on cpu"):
        sa.sorted_accum(rows.cpu(), g, win, win, r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="shared memory"):
        sa.sorted_accum(rows, g, win[:1], win[:1], r_pad=512, wrows=512)
    with pytest.raises(ValueError, match="width"):
        sa.sorted_accum(rows, torch.zeros(1024, 256, device=dev), win, win,
                        r_pad=512, wrows=256)
    with pytest.raises(ValueError, match="aligned"):
        x = torch.zeros(65 * 128 + 1, device=dev)[1:].view(65, 128)
        fs.bpr_sample_phase(x, x, x, K=20, wd=0.0)


def test_bpr_fit_on_card_matches_cpu(dev):
    """Two sgd epochs of the whole trainer on the card and on the CPU
    (plain versions) from the same init: equal to summation order."""
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
        out[str(d)] = (m.W, m.H, m.last_loss, dict(_kernels.launches))
    (Wc, Hc, lc, nc), (Wg, Hg, lg, ng) = out["cpu"], out[str(dev)]
    assert nc == {} and set(ng) == {"bpr_sample_phase", "sorted_accum",
                                    "sorted_accum_dual"}
    np.testing.assert_allclose(Wg, Wc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Hg, Hc, rtol=1e-4, atol=1e-5)
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


@pytest.mark.parametrize("B", [32, 64, 128])
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
