"""Utilities (counterpart of ``zpc_tpu/utils``)."""
