"""Hand-written device kernels: the CUDA chain-frame kernel (chain_cuda)."""
