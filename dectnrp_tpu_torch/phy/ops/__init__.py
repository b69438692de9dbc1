"""Kernel wrappers of the PHY hot ops (CUDA kernel on the card, plain twin on CPU)."""
