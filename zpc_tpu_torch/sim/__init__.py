"""Simulation pipelines (counterpart of ``zpc_tpu/sim``).

The names of ``zpc_tpu.sim`` that the port carries are exported here and
imported on first use; the v1 binned step is superseded by binned2 and not
carried.  Cloth and tet FEM export their steps as ``cloth_implicit_step``
and ``fem_implicit_step``, as the JAX package does."""

import importlib

_EXPORTS = {
    ".mpm": ["MPMSim", "MPMState", "make_mpm_state", "explicit_step"],
    ".mpm_binned2": ["BinnedConfig2", "rollout_binned2",
                     "explicit_step_binned2"],
    ".implicit": ["implicit_step"],
    ".fluid": ["make_fluid_state", "explicit_fluid_step"],
    ".fluid_binned2": ["bin_fluid_state", "explicit_fluid_step_binned2",
                       "rollout_fluid_binned2", "unbin_fluid_state"],
    ".scene": ["Scene"],
    ".runner": ["simulate"],
    ".cloth": ["ClothSim", "make_cloth_grid", "cloth_energy"],
    ".fem": ["FemSim", "make_tet_box", "fem_energy"],
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
# exported names that differ from the module's own: name -> (module, attr)
_RENAMED = {"cloth_implicit_step": (".cloth", "implicit_step"),
            "fem_implicit_step": (".fem", "implicit_step")}
__all__ = list(_WHERE) + list(_RENAMED)


def __getattr__(name):
    mod, attr = _RENAMED.get(name, (_WHERE.get(name), name))
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), attr)
