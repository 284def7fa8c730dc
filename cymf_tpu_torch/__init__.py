"""cymf-tpu on PyTorch and CUDA: the port of the JAX package ``cymf_tpu``
to one NVIDIA H100, with its TPU kernels written by hand for Hopper.

Ported so far: BPR on the packed v4 path, the ALS trainers WMF and
ExpoMF, RelMF and GloVe on their packed engines, and sampled-negative
evaluation; see README.md ("PyTorch / H100 port") for what each covers.
This package imports ``torch`` and never ``jax``.
"""

from .models import BPR, WMF, ExpoMF, GloVe, RelMF
from .evaluation.evaluator import (AoaEvaluator, AverageOverAllEvaluator,
                                   Evaluator, UnbiasedEvaluator)
from . import evaluation as evaluator  # cymf exposes `cymf.evaluator.*`
from . import dataset

__version__ = "0.1.0"
__all__ = ["BPR", "WMF", "ExpoMF", "RelMF", "GloVe", "Evaluator", "AverageOverAllEvaluator",
           "AoaEvaluator", "UnbiasedEvaluator", "dataset", "evaluator"]
