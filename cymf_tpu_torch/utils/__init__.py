from .profiling import Throughput, annotate

__all__ = ["Throughput", "annotate"]
