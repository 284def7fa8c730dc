"""The benchmark of cymf_tpu_torch: ``python benchmark/run.py --help``."""
