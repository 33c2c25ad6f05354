"""The benchmark of the PyTorch/CUDA port (``ray_tpu_torch``): see README.md."""
