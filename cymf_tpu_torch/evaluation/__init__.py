from .evaluator import (AoaEvaluator, AverageOverAllEvaluator, Evaluator,
                        UnbiasedEvaluator)
from . import metrics

__all__ = ["Evaluator", "AverageOverAllEvaluator", "AoaEvaluator",
           "UnbiasedEvaluator", "metrics"]
