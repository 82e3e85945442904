"""Hand-written Hopper kernels, their plain PyTorch versions and the loader."""
