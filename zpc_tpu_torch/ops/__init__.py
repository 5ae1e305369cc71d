"""Hand-written CUDA kernels behind their plain PyTorch versions
(counterpart of ``zpc_tpu/ops``): the prefix scan (:mod:`.scan`) and the
Karras nearest-smaller-element sweep (:mod:`.nse`)."""
