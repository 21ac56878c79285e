"""SetConv operators: plain PyTorch versions and the CUDA kernels."""
