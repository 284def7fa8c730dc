from .checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from .profiling import Throughput, annotate, count, span, spans, trace

__all__ = ["AsyncCheckpointer", "save_checkpoint", "load_checkpoint",
           "trace", "annotate", "Throughput", "span", "count", "spans"]
