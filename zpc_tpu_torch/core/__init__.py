"""Property vocabulary and execution policies (counterpart of
``zpc_tpu/core``)."""
