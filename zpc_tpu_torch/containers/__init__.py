"""Containers: fields, dense fields, structured fields, block tables (packed
and wide keys), ordered maps, ring buffers, index buckets and the LBVH
(counterpart of ``zpc_tpu/containers``)."""
