"""Models of the PyTorch/CUDA package."""
