"""Rendering: the plain PyTorch pipeline and the fused CUDA kernel."""
