"""Datasets of the port: the synthetic generators and the dataset base.
The file-backed loaders (MovieLens, YahooMusic, text8) are not ported yet."""

from .implicit import ImplicitFeedbackDataset
from .synthetic import (SyntheticImplicitDataset, bench_interactions,
                        synthetic_interactions)

__all__ = ["ImplicitFeedbackDataset", "SyntheticImplicitDataset",
           "bench_interactions", "synthetic_interactions"]
