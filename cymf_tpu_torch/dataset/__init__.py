"""Datasets of the port: the file-backed loaders (MovieLens, YahooMusic,
Text8 and ``read_text``), which read and split with numpy alone, and the
synthetic generators, with the JAX package's export list plus
``bench_interactions``."""

from .implicit import ImplicitFeedbackDataset
from .movielens import MovieLens
from .yahoomusic import YahooMusic
from .cooccurrence import CooccurrrenceDataset, CooccurrenceDataset
from .text8 import Text8
from .text import read_text
from .synthetic import (SyntheticImplicitDataset, bench_interactions,
                        synthetic_interactions)

__all__ = ["ImplicitFeedbackDataset", "MovieLens", "YahooMusic",
           "CooccurrrenceDataset", "CooccurrenceDataset", "Text8",
           "read_text", "SyntheticImplicitDataset", "synthetic_interactions",
           "bench_interactions"]
