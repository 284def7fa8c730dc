from .bpr import BPR

__all__ = ["BPR"]
