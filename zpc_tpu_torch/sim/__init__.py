"""Simulation pipelines (counterpart of ``zpc_tpu/sim``)."""
