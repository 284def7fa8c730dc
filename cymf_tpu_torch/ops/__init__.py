"""Device ops of the port.  Kernels are built and loaded at first use
(``_kernels``); importing this package builds nothing."""

from .segment import csr_contains, csr_lookup, dedup_rows
from .hashset import PairHashSet, build_pair_hashset, hashset_contains
from . import als

__all__ = ["dedup_rows", "csr_contains", "csr_lookup",
           "build_pair_hashset", "hashset_contains", "PairHashSet", "als"]
