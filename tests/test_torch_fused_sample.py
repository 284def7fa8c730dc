"""The port's fused BPR sample phase against the JAX package's.

``decorate`` must be exactly equal.  The plain PyTorch version of the
sample kernel must match the Pallas kernel (interpret mode) on the same
decorated rows: ``SW``/``Q`` to ``rtol 1e-5, atol 1e-6`` and the loss sum
to relative ``1e-5`` (the row dot products and the loss sum reduce in
another order).  K covers s=6 (20), s=3 (33) and s=1 (64, 100) slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.ops import fused_sample as jfs
from cymf_tpu.ops import packed as jpk
from cymf_tpu_torch.ops import _kernels
from cymf_tpu_torch.ops import fused_sample as tfs

B, U, I, WD = 1024, 500, 300, 0.01


def _inputs(K, seed=0):
    """Packed W rows gathered by user, logical H rows by item, a live mask
    with collisions and padding zeroed, as one v4 step sees them."""
    rng = np.random.default_rng(seed + K)
    s = jpk.num_slots(K)
    Wp = jpk.pack_array(rng.normal(size=(U, K)) * 0.3, K)
    Hp = jpk.pack_logical(rng.normal(size=(I, K)) * 0.3, K)
    u = np.sort(rng.integers(0, U, B)).astype(np.int32)
    mf = (rng.random(B) > 0.1).astype(np.float32)
    return (Wp[u // s], u % s, mf, Hp[rng.integers(0, I, B)],
            Hp[rng.integers(0, I, B)])


@pytest.mark.parametrize("K", [20, 33, 64, 100])
def test_decorate_matches_jax(K):
    gathered, slot, mf, _, _ = _inputs(K)
    want = np.asarray(jfs.decorate(jnp.asarray(gathered), jnp.asarray(slot),
                                   jnp.asarray(mf), K))
    got = tfs.decorate(torch.from_numpy(gathered.copy()),
                       torch.from_numpy(slot), torch.from_numpy(mf), K)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [20, 33, 64, 100])
def test_sample_phase_plain_matches_jax(K):
    gathered, slot, mf, Di, Dj = _inputs(K)
    Du = np.array(jfs.decorate(jnp.asarray(gathered), jnp.asarray(slot),
                               jnp.asarray(mf), K))
    SWj, Qj, lj = jfs.bpr_sample_phase(jnp.asarray(Du), jnp.asarray(Di),
                                       jnp.asarray(Dj), K=K, wd=WD,
                                       interpret=True)
    _kernels.reset_launches()
    SW, Q, loss = tfs.bpr_sample_phase(
        *(torch.from_numpy(a) for a in (Du, Di, Dj)), K=K, wd=WD)
    assert _kernels.launches["bpr_sample_phase"] == 0
    assert loss.shape == ()
    np.testing.assert_allclose(SW.numpy(), np.asarray(SWj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss), float(lj[0, 0]), rtol=1e-5)


def test_sample_phase_rejects_bad_shapes():
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="128"):
        tfs.bpr_sample_phase(x, x, x[:, :64].contiguous(), K=20, wd=WD)
    with pytest.raises(ValueError, match="packed layout"):
        tfs.bpr_sample_phase(x, x, x, K=128, wd=WD)
