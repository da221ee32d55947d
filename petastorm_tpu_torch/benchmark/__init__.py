"""Benchmarks of the PyTorch/CUDA package (token store so far)."""
