"""Numerical kernels of the port: stratified assignment (CUDA + plain),
k-means updates, PCA moments and the host-f64 analysis tail."""
