"""Containers: fields, dense fields, structured fields, block tables (packed
and wide keys), ordered maps, ring buffers, index buckets, the LBVH with
its queries and pair fronts, and the sweep structure (counterpart of
``zpc_tpu/containers``).

The names of ``zpc_tpu.containers`` that the port carries are exported here
and imported on first use."""

import importlib

_EXPORTS = {
    ".field": ["Field", "field"],
    ".structured": ["StructuredField", "structured_field"],
    ".block_table": ["BlockTable", "build_block_table", "build_overflowed",
                     "pack_coords", "unpack_key"],
    ".dense_field": ["DenseField", "dense_field"],
    ".index_buckets": ["IndexBuckets", "build_index_buckets",
                       "neighbor_candidates"],
    ".bvh": ["LBvh", "build_lbvh", "build_lbvh_complete", "query_overlaps",
             "query_nearest", "query_ray", "aabb_overlap", "BvttFront"],
    ".ordered_map": ["OrderedMap", "ordered_map", "RingBuffer",
                     "ring_buffer"],
    ".bvs": ["Bvs", "build_bvs", "bvs_query"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)
