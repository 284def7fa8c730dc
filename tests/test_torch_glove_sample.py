"""The port's GloVe sample phase (kernel #8) against the JAX package's.

``decorate_x`` and ``augment_tables`` must be exactly equal.  The plain
PyTorch version of the sample kernel must match the Pallas kernel
(interpret mode) on the same decorated rows: ``SW``/``Q`` to
``rtol 1e-5, atol 1e-6`` and the loss sum to relative ``1e-5`` (row dot
products and the loss sum reduce in another order).  ``Kp`` covers
RelMF's K=10 (s=11) and K=20 (s=6) and GloVe's K=50 (Kp=52, s=2); a
tenth of the rows are dead (mask 0, as padding and masked samples are).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import fused_sample as jfs
from cymf_tpu.ops import glove_epoch as jge
from cymf_tpu.ops import packed as jpk
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import fused_sample as tfs
from cymf_tpu_torch.ops import glove_epoch as tge

B, V1, V2 = 1024, 500, 300


def _inputs(Kp, seed=0):
    """One step's decorated rows: packed central rows gathered by id with
    a live mask (10% dead), logical context rows with ``-log(count)`` (or
    ``-theta``) and the weight ``f`` on the decoration lanes."""
    rng = np.random.default_rng(seed + Kp)
    s = jpk.num_slots(Kp)
    Zc = jpk.pack_array(rng.normal(size=(V1, Kp)) * 0.3, Kp)
    Zx = jpk.pack_logical(rng.normal(size=(V2, Kp)) * 0.3, Kp)
    c = np.sort(rng.integers(0, V1, B)).astype(np.int32)
    mf = (rng.random(B) > 0.1).astype(np.float32)
    Du = np.array(jfs.decorate(jnp.asarray(Zc[c // s]), jnp.asarray(c % s),
                               jnp.asarray(mf), Kp))
    gathered = Zx[rng.integers(0, V2, B)]
    f = np.minimum((rng.uniform(1, 50, B) / 10.0) ** 0.75, 1.0).astype(
        np.float32)
    logcnt = np.log(rng.uniform(1, 50, B)).astype(np.float32)
    return Du, gathered, f, logcnt, mf


@pytest.mark.parametrize("Kp", [10, 20, 52])
def test_decorate_x_matches_jax(Kp):
    _, gathered, f, logcnt, _ = _inputs(Kp)
    want = np.asarray(jge.decorate_x(jnp.asarray(gathered), jnp.asarray(f),
                                     jnp.asarray(logcnt), Kp))
    got = tge.decorate_x(torch.from_numpy(gathered.copy()),
                         torch.from_numpy(f), torch.from_numpy(logcnt), Kp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Kp", [10, 20, 52])
def test_sample_phase_plain_matches_jax(Kp):
    Du, gathered, f, logcnt, mf = _inputs(Kp)
    Dx = np.array(jge.decorate_x(jnp.asarray(gathered), jnp.asarray(f),
                                 jnp.asarray(logcnt), Kp))
    SWj, Qj, lj = jge.glove_sample_phase(jnp.asarray(Du), jnp.asarray(Dx),
                                         Kp=Kp, interpret=True)
    _kernels.reset_launches()
    SW, Q, loss = tge.glove_sample_phase(torch.from_numpy(Du),
                                         torch.from_numpy(Dx), Kp=Kp)
    assert _kernels.launches["glove_sample_phase"] == 0
    assert loss.shape == ()
    np.testing.assert_allclose(SW.numpy(), np.asarray(SWj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss), float(lj[0, 0]), rtol=1e-5)
    # dead rows: no slot is found, every output is zero
    dead = mf == 0
    assert dead.sum() > 50
    assert not SW.numpy()[dead].any() and not Q.numpy()[dead].any()
    # live rows carry their mask on Q's lane Kp and a gradient
    np.testing.assert_array_equal(Q.numpy()[:, Kp], mf)
    assert np.abs(Q.numpy()[~dead, :Kp]).sum() > 0


@pytest.mark.parametrize("K", [1, 8, 20, 50, 100, 124, 125, 126])
def test_supports_packed_glove_matches_jax(K):
    assert tge.supports_packed_glove(K) == jge.supports_packed_glove(K)


def test_augment_tables_matches_jax():
    rng = np.random.default_rng(1)
    args = (rng.normal(size=(7, 4)), rng.normal(size=7),
            rng.normal(size=(5, 4)), rng.normal(size=5))
    for got, want in zip(tge.augment_tables(*args),
                         jge.augment_tables(*args)):
        np.testing.assert_array_equal(got, want)


def test_sample_phase_rejects_bad_shapes():
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="128"):
        tge.glove_sample_phase(x, x[:, :64].contiguous(), Kp=20)
    with pytest.raises(ValueError, match="packed layout"):
        tge.glove_sample_phase(x, x, Kp=127)
    Du = tfs.decorate(torch.zeros(64, 128), torch.zeros(64, dtype=torch.int32),
                      torch.ones(64), 20)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tge.glove_sample_phase(Du.to("meta"), Du.to("meta"), Kp=20)
