"""The port's ranking metrics against ``cymf_tpu.evaluation.metrics``.

``tests/test_metrics.py``'s hand-computed cases run against both
packages' scalar forms, and its batch-against-scalar parametrisation
(k in {1, 2, 5, 10} x 4 seeds) holds the port's batch forms to JAX's
batch and to the scalar forms (``rtol 1e-5, atol 1e-7``).  The expected
values are hand-computed from `cymf/metrics.pyx`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cymf_tpu.evaluation import metrics as J
from cymf_tpu_torch.evaluation import metrics as M

Y = np.asarray([1, 0, 1, 0, 1], dtype=np.int32)  # 3 positives
P = np.asarray([0.5, 0.25, 0.5, 1.0, 0.125])
_BOTH = pytest.mark.parametrize("mod", [M, J], ids=["torch", "jax"])


@_BOTH
def test_dcg_hand_computed(mod):
    # k=3: y[0] + y[1]/log2(2) + y[2]/log2(3); y[2]=1 -> 1 + 0 + 1/log2(3)
    want = (1.0 + 1.0 / np.log2(3.0)) / 3.0
    assert mod.dcg_at_k(Y, 3) == pytest.approx(want)


@_BOTH
def test_dcg_k1_counts_slot0_only(mod):
    assert mod.dcg_at_k(Y, 1) == pytest.approx(1.0 / 3.0)
    assert mod.dcg_at_k(np.asarray([0, 1, 1]), 1) == pytest.approx(0.0)


@_BOTH
def test_dcg_no_positives_is_zero(mod):
    assert mod.dcg_at_k(np.zeros(5, np.int32), 3) == 0.0


@_BOTH
def test_recall_hand_computed(mod):
    assert mod.recall_at_k(Y, 3) == pytest.approx(2.0 / 3.0)
    assert mod.recall_at_k(Y, 5) == pytest.approx(1.0)


@_BOTH
def test_map_hand_computed(mod):
    want = (1.0 + 2.0 / 3.0) / 3.0   # hits at ranks 1 and 3 within k=3
    assert mod.average_precision_at_k(Y, 3) == pytest.approx(want)


@_BOTH
def test_dcg_ips_hand_computed(mod):
    sn = (1 / 0.5 + 1 / 0.5 + 1 / 0.125)
    want = (1 / 0.5 + (1 / np.log2(3)) / 0.5) / sn
    assert mod.dcg_at_k_with_ips(Y, P, 3) == pytest.approx(want)


@_BOTH
def test_recall_ips_hand_computed(mod):
    assert mod.recall_at_k_with_ips(Y, P, 3) == pytest.approx(4.0 / 12.0)


@_BOTH
def test_map_ips_hand_computed(mod):
    want = (2.0 / 1.0 + 4.0 / 3.0) / 12.0   # sncum 2 at rank 1, 4 at rank 3
    assert mod.average_precision_at_k_with_ips(Y, P, 3) == \
        pytest.approx(want)


@pytest.mark.parametrize("k", [1, 2, 5, 10])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_matches_scalar_and_jax(seed, k):
    rng = np.random.default_rng(seed)
    L = 12
    labels = (rng.random((6, L)) < 0.3).astype(np.float64)
    labels[0] = 0.0                      # a list without positives
    props = rng.uniform(0.05, 1.0, size=(6, L))
    tl, tp = torch.tensor(labels), torch.tensor(props)
    jl, jp = jnp.asarray(labels), jnp.asarray(props)
    for name in ("dcg_at_k", "recall_at_k", "average_precision_at_k"):
        got = getattr(M, name + "_batch")(tl, k).numpy()
        np.testing.assert_allclose(
            got, np.asarray(getattr(J, name + "_batch")(jl, k)),
            rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(
            got, [getattr(M, name)(r, k) for r in labels], rtol=1e-5,
            atol=1e-7, err_msg=name)
        ips = name + "_with_ips"
        got = getattr(M, ips + "_batch")(tl, tp, k).numpy()
        np.testing.assert_allclose(
            got, np.asarray(getattr(J, ips + "_batch")(jl, jp, k)),
            rtol=1e-5, atol=1e-7, err_msg=ips)
        np.testing.assert_allclose(
            got, [getattr(M, ips)(r, p, k) for r, p in zip(labels, props)],
            rtol=1e-5, atol=1e-7, err_msg=ips)


def test_all_is_jax_all():
    assert sorted(M.__all__) == sorted(J.__all__)
    assert all(callable(getattr(M, n)) for n in M.__all__)
