"""Attention layers of the PyTorch/CUDA package (single device so far)."""
