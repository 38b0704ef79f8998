"""Plain PyTorch references that decide whether a run's outputs are correct.
They import torch and numpy only, nothing of the program under test."""
