"""Front-end and matching operators, and the CUDA kernels (cuda_nn)."""
