"""PyTorch / CUDA port of the UNIQ serving stack (NVIDIA Hopper).

Same sub-package layout as the JAX reference package ``repro`` so a
module's counterpart is found by path.  This package imports ``torch``,
numpy and the standard library only.
"""
