"""Hand-written CUDA kernels behind their plain PyTorch versions
(counterpart of ``zpc_tpu/ops``)."""
