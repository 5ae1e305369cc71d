"""Small-tensor math, B-splines, transforms, morton bit tricks, hashes and
samplers, CSR matrices and solvers (counterpart of ``zpc_tpu/math``)."""
