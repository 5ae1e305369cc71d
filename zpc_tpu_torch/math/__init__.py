"""Small-tensor math, B-splines, transforms
(counterpart of ``zpc_tpu/math``)."""
