"""Hand-written CUDA kernels, their plain PyTorch versions and the dispatch
that picks between them by device."""
