from .checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from .profiling import Throughput, annotate, trace

__all__ = ["AsyncCheckpointer", "save_checkpoint", "load_checkpoint",
           "trace", "annotate", "Throughput"]
