"""Hand-written CUDA kernels behind their plain PyTorch versions
(counterpart of ``zpc_tpu/ops``): the prefix scan (:mod:`.scan`), the
Karras nearest-smaller-element sweep (:mod:`.nse`), and the mesh contact's
per-bin barrier (:mod:`.mesh_barrier`, which has no TPU counterpart)."""
