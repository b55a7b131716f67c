"""Hand-written CUDA kernels of the port, each beside its plain version.

``build`` compiles and loads them and counts their launches; a wrapper
launches its kernel for a CUDA tensor and takes its plain PyTorch
version for a CPU tensor.
"""
