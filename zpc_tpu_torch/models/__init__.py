"""Constitutive models and CFL (counterpart of ``zpc_tpu/models``)."""
