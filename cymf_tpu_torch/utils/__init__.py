from .profiling import Throughput, annotate, trace

__all__ = ["Throughput", "annotate", "trace"]
