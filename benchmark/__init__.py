"""The benchmark of `caduceus_tpu_torch`, the PyTorch / CUDA port (see
README.md). Nothing here imports JAX or the JAX package."""
