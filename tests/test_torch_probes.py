"""The port's probe kernels P1-P3 against the scripts' Pallas kernels.

The JAX functions live in ``scripts/``: P1 ``r5_kernel_variant.py::
phase_v4r``, P2 ``r5_probes.py::copy_phase`` and P3 ``roofline_gather.py::
pallas_gather``.  P1 and P2 read ``sys.argv`` and fix their shapes at
import, and take no ``interpret`` argument, so this file loads them with
``sys.argv`` patched and their ``pl`` replaced by a shim whose
``pallas_call`` runs in interpret mode, and runs P1 at B = 2048.  On the
CPU each port runs its plain form.  Tolerances: P2 and P3 exact (copies
and one float32 add or subtract an element); P1's SW and Q ``rtol 1e-5,
atol 1e-6`` and its loss ``1e-5`` relative, #1's parity bounds
(``tests/test_torch_fused_sample.py``).  P3's plain form raises on ids
outside the table, and its launch plan (``probes.gather_plan``) is held
to a lane's register budget, to float4 that cover the row, and, through
a model of the kernel's batch walk, to writing every output row exactly
once.
"""

import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from cymf_tpu.ops import packed as jpk
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import probes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, WD, LANES = 20, 0.01, 128


def _load_script(name, monkeypatch, B=None):
    """``scripts/<name>.py`` as a module, its Pallas calls interpreted."""
    monkeypatch.setattr(sys, "argv", [name, "1"])
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = types.SimpleNamespace(**{k: getattr(jpl, k) for k in dir(jpl)
                                    if not k.startswith("__")})
    shim.pallas_call = lambda *a, **kw: jpl.pallas_call(
        *a, **{**kw, "interpret": True})
    mod.pl = shim
    if B is not None:
        mod.B = B
    return mod


def _decorated_tiles(B, seed=0):
    """The scripts' inputs: a decorated packed W tile (``mask *
    onehot(slot)`` on the lanes from ``cb``) and logical item tiles, zero
    on lanes >= K (``r5_kernel_variant.py``'s main)."""
    rng = np.random.default_rng(seed)
    s, cb = jpk.num_slots(K), jpk.count_base(K)
    Du = rng.normal(size=(B, LANES)).astype(np.float32)
    slot = rng.integers(0, s, B)
    mf = (rng.random(B) > 0.1).astype(np.float32)
    Du[:, cb:] = 0.0
    Du[np.arange(B), cb + slot] = mf
    Di = rng.normal(size=(B, LANES)).astype(np.float32)
    Dj = rng.normal(size=(B, LANES)).astype(np.float32)
    Di[:, K:] = 0.0
    Dj[:, K:] = 0.0
    return Du, Di, Dj


def test_phase_v4r_plain_matches_script(monkeypatch):
    mod = _load_script("r5_kernel_variant", monkeypatch, B=2048)
    tiles = _decorated_tiles(2048)
    SWj, Qj, lj = mod.phase_v4r(*(jnp.asarray(a) for a in tiles))
    _kernels.reset_launches()
    SW, Q, loss = probes.phase_v4r(*(torch.from_numpy(a) for a in tiles),
                                   K=K, wd=WD)
    assert not _kernels.launches                # the CPU runs plain
    np.testing.assert_allclose(SW.numpy(), np.asarray(SWj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss), float(lj[0, 0]), rtol=1e-5)
    assert not np.asarray(lj)[1:].any() and not np.asarray(lj)[0, 1:].any()


def test_copy_phase_plain_matches_script(monkeypatch):
    mod = _load_script("r5_probes", monkeypatch)
    tiles = _decorated_tiles(1024, seed=1)
    want = mod.copy_phase(*(jnp.asarray(a) for a in tiles))
    got = probes.copy_phase(*(torch.from_numpy(a) for a in tiles))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("R,W,sort", [(1000, 128, False), (300, 256, True),
                                      (64, 384, False)])
def test_gather_rows_plain_matches_script(R, W, sort):
    from scripts.roofline_gather import pallas_gather

    rng = np.random.default_rng(R + W)
    T = rng.normal(size=(R, W)).astype(np.float32)
    idx = rng.integers(0, R, 1024).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    want = pallas_gather(jnp.asarray(T), jnp.asarray(idx), tile=512, q=4,
                         interpret=True)
    got = probes.gather_rows(torch.from_numpy(T), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_wrappers_raise_on_what_they_do_not_take():
    x = torch.zeros(64, LANES)
    with pytest.raises(ValueError, match="must all be"):
        probes.copy_phase(x, x, x[:32])
    with pytest.raises(ValueError, match="must all be"):
        probes.phase_v4r(x, x, torch.zeros(64, 64), K=K, wd=WD)
    with pytest.raises(ValueError, match="packed layout"):
        probes.phase_v4r(x, x, x, K=128, wd=WD)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_in_flight"):
        probes.gather_rows(x, idx, rows_in_flight=3)
    with pytest.raises(ValueError, match="table"):
        probes.gather_rows(x[0], idx)


@pytest.mark.parametrize("bad", [-1, 3, 2**31 - 1])
def test_gather_rows_plain_raises_outside_the_table(bad):
    T = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([0, bad, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        probes.gather_rows_plain(T, idx)
    with pytest.raises(ValueError, match="outside"):
        probes.gather_rows(T, idx)          # the CPU runs plain
    ok = torch.tensor([2, 0], dtype=torch.int32)
    np.testing.assert_array_equal(probes.gather_rows(T, ok).numpy(),
                                  T.numpy()[[2, 0]])


def _batch_walk(plan, B):
    """How often each output row is written, as ``gather_kernel`` walks
    its batches: global warp ``w`` takes batches ``w, w + warps, ...``,
    each ``rows`` rows, the last one cut at ``B``."""
    rows = np.zeros(B, dtype=np.int64)
    warps = plan["blocks"] * probes.GATHER_WARPS
    for w in range(warps):
        for b in range(w, plan["batches"], warps):
            rows[b * plan["rows"]:min((b + 1) * plan["rows"], B)] += 1
    return rows


@pytest.mark.parametrize("W", [4, 128, 256, 384, 1024])
@pytest.mark.parametrize("B", [0, 1, 31, 777, 4099, 131072])
def test_gather_plan_sizes_the_launch(W, B):
    sms = 132
    w4 = W // 4
    for q in probes.ROWS_IN_FLIGHT:
        for per_sm in (1, 3, 8):
            plan = probes.gather_plan(B, W, sms, rows_in_flight=q,
                                      blocks_per_sm=per_sm)
            # a lane's values stay in registers; its float4 cover the row
            assert plan["rows"] * plan["lane4"] <= probes.MAX_LANE_FLOAT4
            assert plan["lane4"] in (1, 2, 4, 8)
            assert plan["rows"] in probes.ROWS_IN_FLIGHT
            assert plan["rows"] <= q
            assert plan["rows"] == q or plan["rows"] * plan["lane4"] == 32
            span = 32 * plan["lane4"]
            assert (plan["passes"] - 1) * span < w4 <= plan["passes"] * span
            assert plan["passes"] == 1 or plan["lane4"] == 8
            assert plan["batches"] == -(-B // plan["rows"])
            assert (plan["blocks"] == 0) == (B == 0)
            assert plan["blocks"] <= per_sm * sms
            # no block without a batch to take
            assert (plan["blocks"] - 1) * probes.GATHER_WARPS \
                < max(plan["batches"], 1)
            np.testing.assert_array_equal(_batch_walk(plan, B), np.ones(B))


def test_gather_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.gather_plan(8, 6, 132)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.gather_plan(8, 0, 132)
    with pytest.raises(ValueError, match="rows_in_flight"):
        probes.gather_plan(8, 128, 132, rows_in_flight=3)
