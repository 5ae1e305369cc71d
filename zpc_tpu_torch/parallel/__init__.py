"""Parallel primitives and the device mesh (counterpart of
``zpc_tpu/parallel``)."""

from . import primitives
from .mesh import make_mesh, shard_leading, replicated, Mesh
