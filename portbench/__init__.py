"""Benchmark of ``zpc_tpu_torch`` on one NVIDIA GPU; see README.md."""
