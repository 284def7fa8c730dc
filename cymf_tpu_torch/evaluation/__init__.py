from .evaluator import (AoaEvaluator, AverageOverAllEvaluator, Evaluator,
                        UnbiasedEvaluator)
from .recommend import recommend
from . import metrics

__all__ = ["Evaluator", "AverageOverAllEvaluator", "AoaEvaluator",
           "UnbiasedEvaluator", "metrics", "recommend"]
