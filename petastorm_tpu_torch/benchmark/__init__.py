"""Benchmarks of the PyTorch/CUDA package: the ImageNet ResNet-50 bench, the
Llama train-step bench, their shared measurement harness, the reader
throughput CLI (``python -m petastorm_tpu_torch.benchmark.cli``) with its
hello-world store, the loader sweep over a mock reader, the transport
micro-benchmark, and the columnar path's scalar-store bench."""
