"""Simulation pipelines (counterpart of ``zpc_tpu/sim``).

The names of ``zpc_tpu.sim`` that the port carries are exported here and
imported on first use; the v1 binned step is superseded by binned2 and not
carried, and cloth and FEM are still to port."""

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
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_WHERE[name], __name__), name)
