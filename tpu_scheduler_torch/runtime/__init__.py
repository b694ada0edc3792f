"""Control loop of the PyTorch/CUDA port: the scheduler, its API boundary
and its resilience machinery (see the package docstring)."""
