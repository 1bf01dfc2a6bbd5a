"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the device-dispatched op surface (``ops``)."""
