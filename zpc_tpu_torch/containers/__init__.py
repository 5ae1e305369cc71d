"""Containers: structured fields, block tables and the LBVH
(counterpart of ``zpc_tpu/containers``)."""
