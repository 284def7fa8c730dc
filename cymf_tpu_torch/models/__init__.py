from .bpr import BPR
from .expomf import ExpoMF
from .wmf import WMF

__all__ = ["BPR", "WMF", "ExpoMF"]
