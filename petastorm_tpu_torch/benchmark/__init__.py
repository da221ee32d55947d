"""Benchmarks of the PyTorch/CUDA package: the Llama train-step bench and
the training benchmarks' shared measurement harness."""
