"""Bridge from ``zpc_tpu`` objects to the port's, and back to numpy.

The converters read the JAX package's dataclasses through ``numpy.asarray``
and class names only, so this module imports no JAX: a caller that holds
``zpc_tpu`` objects already has JAX loaded.  Supported: the explicit MPM
family in 2-D and 3-D (every analytic level set, every elastic and
plasticity model, B-spline orders 1-3, FLIP, elastic, plastic and fluid
states and bin states, configs with the incremental rebin), the LBVH,
the implicit step's mesh contact (``MeshContact``, ``ContactSet``), cloth
(``ClothSim`` with its incidence tables and grid stencil) and tet FEM
(``FemSim`` with its elastic model); anything else raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .containers.block_table import BlockTable
from .containers.bvh import LBvh
from .containers.structured import StructuredField
from .geometry.collider import Collider, ColliderType
from .geometry import levelset as ls_mod
from .geometry.sparse_grid import SparseGrid
from .math.transform import Transform
from .models import constitutive, plasticity
from .sim.cloth import ClothSim, ClothStencil
from .sim.contact_implicit import ContactSet, MeshContact
from .sim.fem import FemSim
from .sim.mpm import MPMSim, MPMState
from .sim.mpm_binned2 import BinnedConfig2, BinState

__all__ = ["sim_from_jax", "config_from_jax", "state_from_jax",
           "binstate_from_jax", "state_to_numpy", "lbvh_from_jax",
           "lbvh_to_numpy", "mesh_contact_from_jax", "contact_set_from_jax",
           "cloth_from_jax", "fem_from_jax"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A JAX or numpy array as a tensor on ``device`` (dtype kept)."""
    return torch.from_numpy(np.array(a)).to(device)


def _levelset_from_jax(ls, device):
    """Any analytic level set of ``zpc_tpu.geometry.levelset``, field for
    field: arrays become tensors, ints (``orient``) stay, wrapped sets
    convert in turn."""
    kind = type(ls).__name__
    cls = getattr(ls_mod, kind, None)
    if cls is None or kind not in ls_mod.__all__ or kind == "LevelSet":
        raise NotImplementedError(f"level set {kind} is not ported")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(ls, f.name)
        if f.name == "base":
            kw[f.name] = _levelset_from_jax(v, device)
        elif f.name == "sets":
            kw[f.name] = tuple(_levelset_from_jax(s, device) for s in v)
        elif isinstance(v, int):
            kw[f.name] = v
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


def _same_fields(obj, module, device):
    """The port's class of ``obj``'s name in ``module``, built field for
    field: arrays become tensors on ``device``, static fields (ints,
    bools) stay as they are."""
    name = type(obj).__name__
    cls = getattr(module, name, None)
    if cls is None or name not in module.__all__:
        raise NotImplementedError(f"{name} is not ported")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = (v if isinstance(v, (bool, int))
                      else _tensor(v, device))
    return cls(**kw)


def sim_from_jax(sim, device: torch.device) -> MPMSim:
    """``zpc_tpu.sim.mpm.MPMSim`` -> :class:`MPMSim`: the elastic model and
    the plasticity model field for field, gravity, the colliders' shapes,
    kinds and friction, the B-spline order and the FLIP blend."""
    colliders = tuple(
        Collider(_levelset_from_jax(c.levelset, device),
                 ColliderType(c.kind.value), float(c.friction))
        for c in sim.colliders)
    plastic = (None if sim.plasticity is None
               else _same_fields(sim.plasticity, plasticity, device))
    return MPMSim(_same_fields(sim.model, constitutive, device),
                  _tensor(sim.gravity, device), colliders, plastic,
                  sim.order, float(sim.flip))


def config_from_jax(cfg) -> BinnedConfig2:
    """``zpc_tpu`` ``BinnedConfig2`` -> the port's, with its incremental
    rebin (``migrate_capacity``) and ``reserve_bins``.  ``chunk_bins``,
    ``sort_chunk`` and ``use_segments`` only restructure the TPU
    computation, so they are dropped.  The port fixes slack 1 and
    recentering: other values raise."""
    if cfg.slack != 1 or not cfg.recenter:
        raise NotImplementedError(
            "only slack=1 and recenter=True are ported, got "
            f"slack={cfg.slack}, recenter={cfg.recenter}")
    return BinnedConfig2(bins_capacity=cfg.bins_capacity,
                         block_capacity=cfg.block_capacity,
                         migrate_capacity=cfg.migrate_capacity,
                         reserve_bins=cfg.reserve_bins)


def _binned_origin(matrix: np.ndarray, dim: int) -> np.ndarray:
    """The origin a ``zpc_tpu`` bin state's step uses: the transform's
    column ``dim`` (column 2 in 2-D, where the other paths keep a 2-D
    grid's origin in column 3)."""
    return np.asarray(matrix)[:dim, dim]


def _grid_from_jax(grid, device, binned: bool = False) -> SparseGrid:
    """The grid field for field.  For a 2-D bin state (``binned``), the
    origin its JAX step uses moves to column 3, where the port keeps it."""
    table = BlockTable(_tensor(grid.table.keys, device),
                       _tensor(grid.table.count, device), grid.table.dim)
    data = {k: _tensor(v, device) for k, v in grid.data.items()}
    tr = None
    if grid.transform is not None:
        m = np.array(grid.transform.matrix)
        if binned and grid.dim == 2:
            m[:2, 3] = _binned_origin(m, 2)
            m[:2, 2] = 0.0
        tr = Transform(torch.from_numpy(m).to(device))
    return SparseGrid(table, data, tr, grid.block_size, grid.dim)


def state_from_jax(state, device: torch.device) -> MPMState:
    """``zpc_tpu.sim.mpm.MPMState`` -> :class:`MPMState`."""
    p = state.particles
    particles = StructuredField(
        {k: _tensor(v, device) for k, v in p.channels.items()}, p.size)
    return MPMState(particles, _grid_from_jax(state.grid, device),
                    _tensor(state.max_vel, device))


# the bin-state widths per dimension: fluid, elastic, plastic
_BIN_LAYOUTS = {3: (18, 26, 27), 2: (11, 14, 15)}


def binstate_from_jax(st, device: torch.device) -> BinState:
    """``zpc_tpu.sim.mpm_binned2.BinState`` (the fluid, elastic and
    plastic layouts: 18, 26 and 27 columns in 3-D, 11, 14 and 15 in 2-D)
    -> :class:`BinState`."""
    if st.cols.shape[1] not in _BIN_LAYOUTS.get(st.grid.dim, ()):
        raise NotImplementedError(
            f"only the 3-D 18-, 26- and 27-column and the 2-D 11-, 14- and "
            f"15-column layouts are ported, got {st.grid.dim}-D with "
            f"{st.cols.shape[1]} columns")
    return BinState(_tensor(st.cols, device), _tensor(st.pid, device),
                    _grid_from_jax(st.grid, device, binned=True),
                    _tensor(st.max_vel, device), _tensor(st.overflow, device),
                    _tensor(st.needs_rebin, device),
                    _tensor(st.bin_block, device), _tensor(st.nbr8, device))


def state_to_numpy(state) -> dict:
    """Numpy arrays of a state of either package (:class:`MPMState` or
    :class:`BinState`, or their ``zpc_tpu`` counterparts): the particle
    channels and ``max_vel`` for an MPM state; cols, pid, bin_block, nbr8,
    flags, table keys and the grid origin its step uses for a bin
    state."""
    def arr(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)
    if hasattr(state, "particles"):
        out = {k: arr(v) for k, v in state.particles.channels.items()}
        out["max_vel"] = arr(state.max_vel)
        return out
    dim = state.grid.dim
    if isinstance(state.cols, torch.Tensor):
        origin = arr(state.grid.origin)
    else:
        origin = _binned_origin(state.grid.transform.matrix, dim)
    return dict(cols=arr(state.cols), pid=arr(state.pid),
                bin_block=arr(state.bin_block), nbr8=arr(state.nbr8),
                overflow=arr(state.overflow),
                needs_rebin=arr(state.needs_rebin),
                table_keys=arr(state.grid.table.keys),
                table_count=arr(state.grid.table.count),
                origin=origin)


_LBVH_FIELDS = [f.name for f in dataclasses.fields(LBvh)]


def lbvh_from_jax(bvh, device: torch.device) -> LBvh:
    """``zpc_tpu.containers.bvh.LBvh`` -> :class:`LBvh` on ``device``,
    field for field (dtypes kept)."""
    return LBvh(**{k: _tensor(getattr(bvh, k), device)
                   for k in _LBVH_FIELDS})


def lbvh_to_numpy(bvh) -> dict:
    """Numpy arrays of every field of an LBVH of either package."""
    out = {}
    for k in _LBVH_FIELDS:
        a = getattr(bvh, k)
        out[k] = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a))
    return out


def mesh_contact_from_jax(mc, device: torch.device) -> MeshContact:
    """``zpc_tpu.sim.contact_implicit.MeshContact`` -> :class:`MeshContact`
    on ``device``: the triangles, the tree (:func:`lbvh_from_jax`) and the
    static fields as they are."""
    return MeshContact(_tensor(mc.tri, device), lbvh_from_jax(mc.bvh, device),
                       float(mc.dhat), float(mc.kappa), int(mc.max_tris),
                       int(mc.tile), bool(mc.use_ccd))


def contact_set_from_jax(cs, device: torch.device) -> ContactSet:
    """``zpc_tpu.sim.contact_implicit.ContactSet`` -> :class:`ContactSet`
    on ``device``."""
    return ContactSet(_tensor(cs.hits, device), _tensor(cs.overflow, device))


def cloth_from_jax(sim, device: torch.device) -> ClothSim:
    """``zpc_tpu.sim.cloth.ClothSim`` -> :class:`ClothSim` on ``device``:
    topology, rest quantities and material field for field, the incidence
    tables when present and the grid stencil (its per-family patches as
    tensors, ``grids`` and ``tri_starts`` as they are)."""
    kw = {}
    for f in dataclasses.fields(ClothSim):
        v = getattr(sim, f.name)
        if v is None or f.name == "stencil":
            kw[f.name] = v
        else:
            kw[f.name] = _tensor(v, device)
    st = sim.stencil
    if st is not None:
        kw["stencil"] = ClothStencil(
            tuple(_tensor(a, device) for a in st.rest_len),
            tuple(_tensor(a, device) for a in st.rest_angle),
            tuple(tuple(int(i) for i in g) for g in st.grids),
            None if st.tri_starts is None
            else tuple(int(i) for i in st.tri_starts))
    return ClothSim(**kw)


def fem_from_jax(sim, device: torch.device) -> FemSim:
    """``zpc_tpu.sim.fem.FemSim`` -> :class:`FemSim` on ``device``: the
    mesh arrays as tensors and the elastic model field for field."""
    kw = {f.name: (_same_fields(sim.model, constitutive, device)
                   if f.name == "model" else
                   _tensor(getattr(sim, f.name), device))
          for f in dataclasses.fields(FemSim)}
    return FemSim(**kw)
