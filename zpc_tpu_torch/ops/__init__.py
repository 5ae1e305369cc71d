"""Hand-written CUDA kernels behind their plain PyTorch versions
(counterpart of ``zpc_tpu/ops``): the prefix scan (:mod:`.scan`), the
Karras nearest-smaller-element sweep (:mod:`.nse`), and two with no TPU
counterpart: the mesh contact's per-bin barrier (:mod:`.mesh_barrier`) and
the implicit step's operator for a FixedCorotated solid
(:mod:`.implicit_apply`)."""
