"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; there is no other switch and no fallback."""
