"""Plain PyTorch and NumPy references that decide ``correct``.  Nothing
here imports the program (``cymf_tpu_torch``) or JAX."""
