"""PyTorch / CUDA port of the BRAMAC serving and training stack (the
`repro` package is the JAX reference it is held against).

Layout mirrors `repro`: configs/ core/ kernels/ (with kernels/csrc/ for the
hand-written Hopper CUDA sources) models/ optim/ data/ checkpoint/
runtime/ launch/.  Importing the package imports torch and numpy only;
kernels are built on first use.
"""
