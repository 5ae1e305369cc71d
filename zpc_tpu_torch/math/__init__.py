"""Small-tensor math, B-splines, transforms, morton bit tricks
(counterpart of ``zpc_tpu/math``)."""
