"""Covariance tile kernels (CUDA) and their PyTorch fronts."""
