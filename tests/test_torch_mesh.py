"""The port's mesh layer and the sharded engines' host prep, against the
JAX package's, in one process.

``cymf_tpu_torch.parallel.MeshContext`` at a world of one (no process
group: every collective is the identity), its row layout (``pad_rows``,
``put_table``) against the shards of the JAX ``MeshContext``'s table
sharding at 1, 3 and 8 devices, ``use_mesh`` nesting, and every entry point's refusal of a ``device``
other than the rank's under a mesh of more than one rank.  The five numpy
prep functions of the sharded BPR engines (``shard_slices``,
``prep_shard_static``, ``prep_shard_epoch``, ``prep_shard_static_wide``,
``wide_shard_masks``) and sharded packed GloVe's
``prep_glove_shard_static`` must equal the JAX ones bit for bit on the
same inputs, at shapes where nothing divides evenly.  The multi-rank runs are in
``test_torch_multidevice.py``.
"""

import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy import sparse

import cymf_tpu.ops.glove_epoch as jge
import cymf_tpu.ops.packed_epoch as jpe
import cymf_tpu.ops.wide_epoch as jwe
import cymf_tpu_torch as ct
import cymf_tpu_torch.ops.glove_epoch as tge
import cymf_tpu_torch.ops.packed as pk
import cymf_tpu_torch.ops.packed_epoch as tpe
import cymf_tpu_torch.ops.wide_epoch as twe
from cymf_tpu.parallel import MeshContext as JaxMesh
from cymf_tpu_torch.models.bpr import PAD_USER, sorted_batches
from cymf_tpu_torch.parallel import (MeshContext, current_mesh,
                                     initialize_distributed, use_mesh)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _fake_mesh(rank: int, n: int) -> MeshContext:
    """Rank ``rank`` of a world of ``n`` without a process group: enough
    for the layout and for the checks made before any collective."""
    return MeshContext(None, rank, n, CPU)


def test_world_of_one():
    m = MeshContext.create()
    assert (m.group, m.rank, m.num_devices) == (None, 0, 1)
    assert m.device == torch.device("cuda", 0)  # the card, not the CPU
    assert current_mesh() == m
    c = MeshContext.create(device="cpu")
    assert c.device == CPU and c.pad_rows(7) == 7
    t = torch.arange(6.0).reshape(3, 2)
    assert c.all_reduce(t) is t and c.all_gather(t) is t
    assert c.reduce_scatter(t) is t
    assert c.broadcast_float(0.25) == 0.25 and c.agree(3, "x") == 3
    c.barrier()
    assert torch.equal(c.put_table(t.numpy()), t)
    assert torch.equal(c.put_replicated(t), t)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pad_rows_and_put_table_match_jax(n):
    jm = JaxMesh.create(jax.devices()[:n])
    rng = np.random.default_rng(n)
    for rows in (1, 17, 64):
        assert _fake_mesh(0, n).pad_rows(rows) == jm.pad_rows(rows)
        T = rng.standard_normal((jm.pad_rows(rows), 5)).astype(np.float32)
        arr = jm.put_table(T)
        shards = sorted(arr.addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        assert len(shards) == n
        for p, sh in enumerate(shards):
            got = _fake_mesh(p, n).put_table(T)
            assert got.dtype == torch.float32 and got.device == CPU
            np.testing.assert_array_equal(got.numpy(), np.asarray(sh.data))
    with pytest.raises(ValueError, match="pad_rows"):
        _fake_mesh(0, 3).put_table(np.zeros((4, 2)))


def test_use_mesh_nesting():
    outer, inner = _fake_mesh(0, 2), _fake_mesh(1, 4)
    seen = []
    with use_mesh(outer):
        assert current_mesh() is outer
        with use_mesh(inner) as got:
            assert got is inner and current_mesh() is inner
            # thread-local: another thread sees the default world
            th = threading.Thread(
                target=lambda: seen.append(current_mesh().num_devices))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        assert current_mesh() is outer
    assert current_mesh().num_devices == 1 and seen == [1]


def test_initialize_distributed_none_does_nothing():
    initialize_distributed(None)
    initialize_distributed(None, num_processes=4, process_id=2)
    assert not dist.is_initialized()
    assert current_mesh().num_devices == 1


def test_mesh_device_mismatch_raises():
    from cymf_tpu_torch.dataset import SyntheticImplicitDataset
    d = SyntheticImplicitDataset(num_user=40, num_item=30, rank=3,
                                 density=0.2, seed=1)
    with use_mesh(_fake_mesh(0, 2)):
        with pytest.raises(ValueError, match="mesh device"):
            ct.BPR(num_components=4, device="meta").fit(
                d.train, num_epochs=1, verbose=False)
        with pytest.raises(ValueError, match="mesh device"):
            ct.Evaluator(d.test, d.train, device="meta").evaluate(
                np.zeros((40, 4)), np.zeros((30, 4)))
        with pytest.raises(ValueError, match="mesh device"):
            ct.recommend(np.zeros((40, 4)), np.zeros((30, 4)), k=3,
                         device="meta")
        for model in (ct.WMF(num_components=4, device="meta"),
                      ct.ExpoMF(num_components=4, device="meta"),
                      ct.RelMF(num_components=4, device="meta")):
            with pytest.raises(ValueError, match="mesh device"):
                model.fit(d.train, num_epochs=1, verbose=False)
        with pytest.raises(ValueError, match="mesh device"):
            ct.GloVe(num_components=4, device="meta").fit(
                sparse.csr_matrix(np.eye(5)), num_epochs=1)


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import cymf_tpu_torch.parallel\n"
            "import cymf_tpu_torch.parallel.shard_step\n"
            "import cymf_tpu_torch.models.bpr\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'cymf_tpu.')) or m == 'cymf_tpu']\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# (U, I, K, batch, n): users, items, batch and rows divide by nothing
PREP_CASES = [(3001, 1203, 12, 2048, 3), (1301, 403, 40, 1024, 4),
              (517, 211, 5, 1024, 8)]


def _streams(U, I, K, batch, n, wide):
    """Sorted steps of a random interaction set (PAD_USER padding), the
    table rows of each engine and a random negative stream and mask."""
    rng = np.random.default_rng(U)
    nnz = U * 6
    users = rng.integers(0, U, nnz).astype(np.int32)
    items = rng.integers(0, I, nnz).astype(np.int32)
    u2, i2 = sorted_batches(users, items, batch)
    assert (u2 == PAD_USER).any()
    if wide:
        rw, rh = twe.wide_rows(U, 512 * n), twe.wide_rows(I, 512)
    else:
        rw = pk.packed_rows(U, K, multiple=256 * n)
        rh = pk.logical_rows(I, multiple=256)
    j2 = rng.integers(0, I, u2.shape).astype(np.int32)
    mask = (rng.random(u2.shape) < 0.9).astype(np.uint8)
    mask[u2 == PAD_USER] = 0
    return u2, i2, rw, rh, j2, mask


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("case", PREP_CASES)
@pytest.mark.parametrize("fn", ["shard_slices", "prep_shard_static",
                                "prep_shard_epoch", "prep_shard_static_wide",
                                "wide_shard_masks"])
def test_shard_prep_bit_equal_to_jax(fn, case):
    U, I, K, batch, n = case
    wide = fn in ("prep_shard_static_wide", "wide_shard_masks")
    u2, i2, rw, rh, j2, mask = _streams(U, I, K, batch, n, wide)
    if fn == "shard_slices":
        _equal(tpe.shard_slices(u2, K, rw, n), jpe.shard_slices(u2, K, rw, n))
        _equal(tpe.shard_slices(u2, 0, rw, n, slots=1),
               jpe.shard_slices(u2, 0, rw, n, slots=1))
        return
    if fn == "prep_shard_static":
        args = (u2, i2, K, rw, rh, 256, 256, n)
        want = jpe.prep_shard_static(*args)
        _equal(tpe.prep_shard_static(*args), want)
        # a rank's own shard: the slice of the whole
        p = n - 1
        _equal(tpe.prep_shard_static(*args, shard=p),
               [a[p:p + 1] for a in want[:6]] + list(want[6:]))
        return
    if fn == "prep_shard_static_wide":
        args = (u2, i2, rw, rh, 512, n)
        want = jwe.prep_shard_static_wide(*args)
        _equal(twe.prep_shard_static_wide(*args), want)
        p = n - 1
        _equal(twe.prep_shard_static_wide(*args, shard=p),
               [a[p:p + 1] for a in want[:7]] + list(want[7:]))
        return
    wrows = 512 if wide else 256
    starts, counts, Bd = tpe.shard_slices(u2, 0 if wide else K, rw, n,
                                          slots=1 if wide else None)
    eargs = (j2, mask, starts, counts, Bd, rh, wrows, n)
    want = jpe.prep_shard_epoch(*eargs)
    got = tpe.prep_shard_epoch(*eargs)
    if fn == "prep_shard_epoch":
        _equal(got, want)
        _equal(tpe.prep_shard_epoch(*eargs, shard=1),
               [a[1:2] for a in want])
        return
    si = twe.prep_shard_static_wide(u2, i2, rw, rh, wrows, n)[4]
    _equal(twe.wide_shard_masks(got[1], si, got[2]),
           jwe.wide_shard_masks(want[1], si, want[2]))


# (V1, V2, K, batch, n): words, batch and rows divide by nothing
GLOVE_PREP_CASES = [(3001, 2003, 8, 2048, 3), (1301, 1307, 30, 1024, 4),
                    (517, 499, 5, 1024, 8)]


@pytest.mark.parametrize("case", GLOVE_PREP_CASES)
def test_glove_shard_prep_bit_equal_to_jax(case):
    """``prep_glove_shard_static`` on central-sorted steps of random
    triples (the fit's padding sentinel last): every array equal to the
    JAX package's, and ``shard=p`` its shard ``p``."""
    V1, V2, K, batch, n = case
    rng = np.random.default_rng(V1)
    N = V1 * 5
    S = -(-N // batch)
    c = np.full(S * batch, 2**31 - 1, np.int32)
    c[:N] = rng.integers(0, V1, N)
    x = np.zeros(S * batch, np.int32)
    x[:N] = rng.integers(0, V2, N)
    cnt = np.ones(S * batch)
    cnt[:N] = rng.integers(1, 40, N)
    c2, x2, n2 = (a.reshape(S, batch) for a in (c, x, cnt))
    order = np.argsort(c2, axis=1, kind="stable")
    c2, x2, n2 = (np.take_along_axis(a, order, axis=1)
                  for a in (c2, x2, n2))
    rw = pk.packed_rows(V1, K + 2, multiple=256 * n)
    rh = pk.logical_rows(V2, multiple=256)
    args = (c2, x2, n2, V1, K, rw, rh, 256, 256, n, 10.0, 0.75)
    want = jge.prep_glove_shard_static(*args)
    _equal(tge.prep_glove_shard_static(*args), want)
    p = n - 2
    _equal(tge.prep_glove_shard_static(*args, shard=p),
           [a[p:p + 1] for a in want[:9]] + [want[9]])
