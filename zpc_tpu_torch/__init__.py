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

Precision policy: fp32 throughout, TF32 off.  The JAX package pins
``Precision.HIGH``/``HIGHEST`` at every contraction (``zpc_tpu/math/
vecmat.py``), and the small-matrix physics depends on it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["cuda_device"]


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no CUDA device is present
    (never substitutes the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", index)
