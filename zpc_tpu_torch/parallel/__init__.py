"""Parallel primitives (counterpart of ``zpc_tpu/parallel``)."""
