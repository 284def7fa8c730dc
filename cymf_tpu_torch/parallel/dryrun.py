"""The multi-device dry run: every sharded trainer, the evaluator and
``recommend`` through the public API under one mesh.

Port of `__graft_entry__.py:98-196::dryrun_multichip`.  The JAX form
builds an ``n``-device mesh of one controller; here every rank of an
initialised process group calls :func:`dryrun_multichip` inside
``use_mesh`` (or with the default group's world), one rank a device, and
the fits take their mesh branches (``parallel/shard_step.py``).  The JAX
file's other entry point, ``entry()``, compiles the packed v4 step on one
chip; it has no counterpart here: ``chip_smoke.py`` builds every kernel on
the card and holds each against its plain version at its main-path
shapes.

Run by hand on CPU ranks::

    dist.init_process_group("gloo", init_method=..., rank=r, world_size=n)
    with use_mesh(MeshContext.create(device="cpu")):
        dryrun_multichip()
"""

from __future__ import annotations

import numpy as np
from scipy import sparse

from .mesh import current_mesh


def _finite(what: str, *arrays) -> None:
    for a in arrays:
        if not np.isfinite(np.asarray(a, np.float64)).all():
            raise AssertionError(f"dry run: {what} is not finite")


def dryrun_multichip() -> dict:
    """Fits every trainer once on the current mesh's ranks, each on its
    sharded path, then evaluates and recommends; raises
    ``AssertionError`` on a non-finite result or a wrong shape.  Every
    rank calls it together.  Returns, by trainer, its last loss (or, for
    the ALS trainers, its tables' sum), the same on every rank."""
    from .. import AoaEvaluator, recommend
    from ..dataset import SyntheticImplicitDataset
    from ..models import BPR, WMF, ExpoMF, GloVe, RelMF

    n = current_mesh().num_devices
    data = SyntheticImplicitDataset(num_user=48, num_item=72, rank=4,
                                    density=0.2, seed=0)
    batch = max(n * 8, 32)
    out = {}
    # BPR on the batch, packed and wide engines (shard_step.py's three
    # BPR epochs)
    for what, kw in (
            ("bpr-batch", dict(num_components=16, batch_size=batch,
                               packed="off")),
            ("bpr-packed", dict(num_components=8, batch_size=batch,
                                packed="on")),
            ("bpr-wide", dict(num_components=128, batch_size=1024,
                              packed="on", optimizer="sgd"))):
        m = BPR(learning_rate=0.01, **kw)
        m.fit(data.train, num_epochs=2 if what == "bpr-batch" else 1,
              verbose=False, seed=0)
        _finite(what, m.last_loss, m.W, m.H)
        if m.W.shape != (48, kw["num_components"]) or m.engine_ != \
                what.split("-")[1]:
            raise AssertionError(f"dry run: {what} ran {m.engine_}, "
                                 f"W {m.W.shape}")
        out[what] = m.last_loss
        if what == "bpr-batch":
            bpr = m

    # RelMF takes its sharded batch engine on a mesh
    r = RelMF(num_components=8, learning_rate=0.01, batch_size=batch)
    r.fit(data.train, num_epochs=1, verbose=False, seed=0)
    _finite("relmf", r.last_loss, r.W, r.H)
    out["relmf"] = r.last_loss

    # the ALS trainers' sharded chunk solves
    e = ExpoMF(num_components=8, chunk_size=16)
    e.fit(data.train, num_epochs=1, verbose=False)
    _finite("expomf", e.W, e.H, e.mu)
    if e.mu.shape != (72,):
        raise AssertionError(f"dry run: ExpoMF mu {e.mu.shape}")
    out["expomf"] = float(e.W.sum() + e.H.sum())
    w = WMF(num_components=8, chunk_size=16)
    w.fit(data.train, num_epochs=1, verbose=False)
    _finite("wmf", w.W, w.H)
    out["wmf"] = float(w.W.sum() + w.H.sum())

    # GloVe: the packed engine and the batch engine's two bias modes
    grng = np.random.default_rng(2)
    gd = (grng.random((40, 40)) < 0.2) * grng.integers(1, 20, (40, 40))
    np.fill_diagonal(gd, 0)
    G = sparse.csr_matrix(gd.astype(np.float64))
    for what, kw in (("glove-packed", dict(packed="on")),
                     ("glove-fused", dict(packed="off")),
                     ("glove-kfold", dict(packed="off", bias_mode="kfold"))):
        g = GloVe(num_components=8, batch_size=64, **kw)
        g.fit(G, num_epochs=1)
        _finite(what, g.last_loss, g.W)
        if g.W.shape != (40, 8) or g.packed_engine_ != (what ==
                                                        "glove-packed"):
            raise AssertionError(f"dry run: {what} W {g.W.shape}")
        out[what] = g.last_loss

    # the user-partitioned evaluator and the distributed top-k, on the
    # batch engine's BPR tables
    res = AoaEvaluator(data.test, data.train, metrics=["DCG"],
                       k=5).evaluate(bpr.W, bpr.H)
    _finite("the evaluator", res["DCG@5"])
    scores, ids = recommend(bpr.W, bpr.H, k=3, exclude=data.train)
    if ids.shape != (48, 3):
        raise AssertionError(f"dry run: recommend gave {ids.shape}")
    _finite("recommend", scores)
    out["DCG@5"] = res["DCG@5"]
    return out
