"""cymf-tpu on PyTorch and CUDA: the port of the JAX package ``cymf_tpu``
to one NVIDIA H100, with its TPU kernels written by hand for Hopper.

Ported so far: BPR on its packed (with host or device prep), wide, batch
and sequential engines, the ALS trainers WMF and ExpoMF, RelMF and GloVe
on their packed, batch and sequential engines, checkpoints and resume on
every engine but the sequential one, the row-sparse optimizers
(``optim``), sampled-negative evaluation, the ranking metrics,
full-catalog ``recommend``, the dataset loaders (MovieLens,
YahooMusic, Text8, ``read_text``), and on a mesh of ranks
(``cymf_tpu_torch.parallel``, one process per device over
``torch.distributed``) BPR's sharded packed, wide and batch engines with
the sharded evaluator and ``recommend``; see README.md ("PyTorch / H100
port") for what each covers.  Not ported yet: the sharded engines of
WMF, ExpoMF, RelMF and GloVe, whose fits raise under a mesh of more than
one rank.
This package imports ``torch`` and never ``jax``; pandas only where a
loader returns a frame.
"""

from .models import BPR, WMF, ExpoMF, GloVe, RelMF
from .evaluation.evaluator import (AoaEvaluator, AverageOverAllEvaluator,
                                   Evaluator, UnbiasedEvaluator)
from .evaluation.recommend import recommend
from . import evaluation as evaluator  # cymf exposes `cymf.evaluator.*`
from . import dataset
from . import optim
from .parallel import MeshContext, current_mesh, use_mesh

__version__ = "0.1.0"
__all__ = ["BPR", "WMF", "ExpoMF", "RelMF", "GloVe", "Evaluator", "AverageOverAllEvaluator",
           "AoaEvaluator", "UnbiasedEvaluator", "dataset", "evaluator",
           "optim", "recommend", "MeshContext", "current_mesh", "use_mesh"]
