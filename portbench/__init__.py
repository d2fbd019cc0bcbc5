"""The benchmark of ``tpufusion_torch`` (the PyTorch and CUDA port) on one
H100: see ``README.md``. It imports neither JAX nor the JAX package, and
only ``program.py`` imports the port."""
