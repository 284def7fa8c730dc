from .profiling import Throughput

__all__ = ["Throughput"]
