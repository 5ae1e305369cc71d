"""Level sets, colliders, sparse grids
(counterpart of ``zpc_tpu/geometry``)."""
