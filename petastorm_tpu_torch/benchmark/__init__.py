"""Benchmarks of the PyTorch/CUDA package: the ImageNet ResNet-50 bench, the
Llama train-step bench, their shared measurement harness, the per-step
input-stall measurement and the columnar path's scalar-store bench."""
