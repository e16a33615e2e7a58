"""The benchmark of the PyTorch / CUDA port (`sapling_tpu_torch`); see
harness.py. It imports nothing of the JAX package."""
