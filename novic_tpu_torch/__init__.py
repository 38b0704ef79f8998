"""novic_tpu_torch: the PyTorch/CUDA port of novic_tpu.

Serves open-vocabulary image classification (image in, free-form noun out) on
an NVIDIA GPU. Plain tensor code is PyTorch; the tower self-attention runs a
hand-written CUDA kernel (ops/csrc/attention.cu). Entry points run on CUDA
unless the caller asks for the CPU (see device.py).
"""
