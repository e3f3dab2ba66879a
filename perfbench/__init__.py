"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`)."""
