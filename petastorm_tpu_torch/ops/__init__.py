"""On-device ops of the input tail and the models: image normalization and
flash attention, each backed by hand-written kernels, and the batch
augmentations (plain PyTorch: the JAX package's are ``jnp`` code, not
kernels)."""
