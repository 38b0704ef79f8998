"""Data and tensor parallelism over torch.distributed (mesh.py, tp.py)."""
