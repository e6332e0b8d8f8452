"""PyTorch / CUDA port of the BRAMAC serving stack (the `repro` package is
the JAX reference it is held against).

Layout mirrors `repro`: configs/ core/ kernels/ (with kernels/csrc/ for the
hand-written Hopper CUDA sources) models/ runtime/ launch/.  Importing the
package imports torch and numpy only; kernels are built on first use.
"""
