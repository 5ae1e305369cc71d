"""Small-tensor math, B-splines, transforms, morton bit tricks, hashes and
samplers, CSR matrices and solvers, and exact wide integers and fractions
(counterpart of ``zpc_tpu/math``).

The names of ``zpc_tpu.math`` that the port carries are exported here and
imported on first use (the parallel primitives import ``math.bits``, and
the CSR module imports the primitives)."""

import importlib

_EXPORTS = {
    ".svd": ["svd2x2", "svd3x3", "polar_decomposition", "polar_newton3x3",
             "eigh3x3", "qr3x3"],
    ".interpolation": ["bspline_weights", "linear_bspline_weights",
                       "quadratic_bspline_weights", "cubic_bspline_weights",
                       "stencil_size", "base_node"],
    ".sparse": ["CSRMatrix", "csr_from_coo", "csr_transpose", "spmv",
                "spmv_semiring", "spmv_mask", "SEMIRINGS"],
    ".solvers": ["cg", "conjugate_residual", "minres", "dot", "axpy",
                 "SolveResult"],
    ".transform": ["Transform", "translation", "scaling",
                   "rotation_transform", "quat_identity",
                   "quat_from_axis_angle", "quat_mul", "quat_rotate",
                   "quat_to_matrix", "quat_from_matrix", "quat_normalize",
                   "quat_slerp", "euler_to_matrix", "rotation_x",
                   "rotation_y", "rotation_z"],
    ".bits": ["morton3d", "morton2d", "clz32", "common_prefix_length",
              "next_pow2", "expand_bits_3d"],
    ".bigint": ["BigInt", "bigint", "bigint_gcd", "RationalW", "rational_w"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)
