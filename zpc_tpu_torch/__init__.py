"""zpc_tpu_torch — the PyTorch/CUDA port of ``zpc_tpu`` for NVIDIA Hopper.

The package mirrors ``zpc_tpu``'s module paths (``zpc_tpu_torch/sim/
mpm_binned2.py`` is the counterpart of ``zpc_tpu/sim/mpm_binned2.py``) and is
checked against it on the same inputs.  Plain tensor code is PyTorch; every
kernel that the JAX package wrote in Pallas for the TPU is a hand-written
CUDA kernel under ``csrc/``, built at first use (:mod:`._kernels`): the
prefix scan (``ops/scan.py``, ``csrc/scan.cu``) and the Karras
nearest-smaller-element sweep of the LBVH build (``ops/nse.py``,
``csrc/nse.cu``).  A
tensor on the CPU takes each kernel's plain PyTorch version; a tensor on a
CUDA device launches the kernel or raises.

The top level exports what ``zpc_tpu`` exports: the policies
(``tpu_exec()`` is the card's, ``seq_exec()`` the CPU oracle's), the
containers and the parallel primitives, which take the policy first::

    import zpc_tpu_torch as z
    pol = z.tpu_exec()
    z.reduce(pol, x); z.exclusive_scan(pol, x); z.radix_sort(pol, keys)

Precision policy: fp32 throughout, TF32 off.  The JAX package pins
``Precision.HIGH``/``HIGHEST`` at every contraction (``zpc_tpu/math/
vecmat.py``), and the small-matrix physics depends on it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.config import Layout, MemSrc, PropertyTag, prop  # noqa: E402
from .core.executor import (Executor, cuda_device, jit_exec,  # noqa: E402
                            seq_exec, tpu_exec)
from .containers.field import Field, field  # noqa: E402
from .containers.structured import (StructuredField,  # noqa: E402
                                    structured_field)
from .containers.block_table import (BlockTable,  # noqa: E402
                                     build_block_table, pack_coords,
                                     unpack_key)
from .parallel import primitives  # noqa: E402
from .parallel.primitives import (count_if, exclusive_scan,  # noqa: E402
                                  histogram, inclusive_scan, merge_sort,
                                  merge_sort_pair, radix_sort,
                                  radix_sort_pair, reduce, segment_reduce,
                                  select_if, sort, sort_pair, unique)

__all__ = [
    "cuda_device",
    "Layout", "MemSrc", "PropertyTag", "prop",
    "Executor", "seq_exec", "tpu_exec", "jit_exec",
    "Field", "field", "StructuredField", "structured_field",
    "BlockTable", "build_block_table", "pack_coords", "unpack_key",
    "primitives", "reduce", "inclusive_scan", "exclusive_scan",
    "sort", "sort_pair", "merge_sort", "merge_sort_pair",
    "radix_sort", "radix_sort_pair", "histogram", "segment_reduce",
    "count_if", "select_if", "unique",
]
