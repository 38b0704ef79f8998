"""The benchmark of novic_tpu_torch, the PyTorch and CUDA port (see README.md)."""
