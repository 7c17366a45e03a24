"""The benchmark of syzgydb_tpu_torch, the PyTorch and CUDA port (see
harness.py).  Nothing here imports JAX or the JAX package."""
