"""Property vocabulary (counterpart of ``zpc_tpu/core``)."""
