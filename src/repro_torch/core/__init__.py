"""Quantization primitives of the port: packing, distributions, quantizers."""
