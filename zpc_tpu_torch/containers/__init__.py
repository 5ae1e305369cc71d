"""Containers: structured fields and block tables
(counterpart of ``zpc_tpu/containers``)."""
