"""Device ops of the port.  Kernels are built and loaded at first use
(``_kernels``); importing this package builds nothing."""

from .hashset import PairHashSet, build_pair_hashset, hashset_contains

__all__ = ["PairHashSet", "build_pair_hashset", "hashset_contains"]
