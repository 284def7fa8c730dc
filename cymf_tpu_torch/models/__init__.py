from .bpr import BPR
from .expomf import ExpoMF
from .glove import GloVe
from .relmf import RelMF
from .wmf import WMF

__all__ = ["BPR", "WMF", "ExpoMF", "RelMF", "GloVe"]
