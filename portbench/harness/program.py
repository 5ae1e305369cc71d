"""The system under test, ``zpc_tpu_torch``, built from a configuration
through its public constructors and driven through its entry points.

:class:`Program` makes the scene (particles, material, colliders, the
obstacle), enters bin order with ``bin_state`` and runs chains of
``adaptive_chain`` over the configuration's step and ``rebin_adaptive``,
as ``rollout_binned2`` composes them.  The step and the rebin are the
benchmark's own lambdas: each call runs inside a
``torch.profiler.record_function`` span (``portbench.step``,
``portbench.rebin``) and is counted, and the implicit step's CG iteration
counts (``with_stats``) are kept; ``step_hook``, when set, is called
before each step (the traced slice starts and stops there).  The program
is looked up through its modules at every call, so a test can break the
timed path underneath.  Where the traffic has contact, the obstacle is
``MeshContact.build`` over the benchmark's triangles with the
configuration's ``dhat``, ``kappa``, ``max_tris`` and join ``tile``.
:func:`program_counters` reads the program's own counters: every
``collections.Counter`` that ``zpc_tpu_torch.utils.profile`` exports.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List

import torch
from torch.profiler import record_function

from zpc_tpu_torch.geometry import collider as collider_mod
from zpc_tpu_torch.geometry import levelset as ls
from zpc_tpu_torch.models import constitutive
from zpc_tpu_torch.sim import contact_implicit as ci
from zpc_tpu_torch.sim import implicit_binned2 as ib2
from zpc_tpu_torch.sim import mpm as mpm_mod
from zpc_tpu_torch.sim import mpm_binned2 as b2
from zpc_tpu_torch.utils import profile as zprof

__all__ = ["Counters", "Program", "program_counters", "STEP_SPAN",
           "REBIN_SPAN", "SYNC_SPAN"]

STEP_SPAN, REBIN_SPAN, SYNC_SPAN = ("portbench.step", "portbench.rebin",
                                    "portbench.sync")


@dataclasses.dataclass
class Counters:
    steps: int = 0
    rebins: int = 0
    cg_iters: List[int] = dataclasses.field(default_factory=list)


def program_counters() -> Dict[str, int]:
    """``<COUNTER>.<site>`` -> count, over every ``collections.Counter``
    named in ``zpc_tpu_torch.utils.profile.__all__`` (``HOST_SYNCS``:
    host syncs of the stepping code by site); empty where it exports
    none."""
    out = {}
    for name in getattr(zprof, "__all__", ()):
        c = getattr(zprof, name, None)
        if isinstance(c, collections.Counter):
            out.update((f"{name}.{site}", n) for site, n in c.items())
    return out


def _colliders(cfg: dict, dev) -> tuple:
    f32 = dict(dtype=torch.float32, device=dev)
    out = []
    for c in cfg["colliders"]:
        if c["levelset"] == "half_space":
            lset = ls.HalfSpace(torch.tensor(c["origin"], **f32),
                                torch.tensor(c["normal"], **f32))
        elif c["levelset"] == "box_walls":
            lset = ls.ComplementLevelSet(ls.Cuboid(
                torch.full((3,), c["lo"], **f32),
                torch.full((3,), c["hi"], **f32)))
        else:
            raise ValueError(f"unknown level set {c['levelset']!r}")
        out.append(collider_mod.Collider(
            lset, collider_mod.ColliderType(c["kind"])))
    return tuple(out)


class Program:
    """The configuration's scene on the program, from the benchmark's
    inputs (:class:`~portbench.harness.inputs.Inputs`): the particles, the
    obstacle's triangles where the traffic has contact, and ``dt``."""

    def __init__(self, cfg: dict, inp):
        dev = inp.x0.device
        mat = cfg["material"]
        self.template = mpm_mod.make_mpm_state(
            inp.x0.clone(), dx=cfg["dx"], device=dev, rho=mat["rho"],
            ppc=mat["ppc"], block_capacity=cfg["state_block_capacity"],
            velocity=None if inp.v0 is None else inp.v0.clone())
        model = getattr(constitutive, mat["model"]).from_young_poisson(
            mat["E"], mat["nu"], device=dev)
        self.sim = mpm_mod.MPMSim(
            model=model,
            gravity=torch.tensor(cfg["gravity"], dtype=torch.float32,
                                 device=dev),
            colliders=_colliders(cfg, dev))
        self.dt = inp.dt
        self.bins = b2.BinnedConfig2(**cfg["bins"])
        self.integrator = cfg["integrator"]
        self.contact = None
        if inp.tri is not None:
            ob = cfg["obstacle"]
            self.contact = ci.MeshContact.build(
                inp.tri, ob["dhat"], ob["kappa"], max_tris=ob["max_tris"],
                tile=ob["tile"])
        self.counters = Counters()
        self.step_hook = None
        self.start = b2.bin_state(self.sim, self.template, self.bins)

    def step(self, s):
        if self.step_hook is not None:
            self.step_hook()
        with record_function(STEP_SPAN):
            if self.integrator["kind"] == "explicit":
                out = b2.explicit_step_binned2(self.sim, s, self.dt,
                                               self.bins, rebin=False)
            else:
                out, it = ib2.implicit_step_binned2(
                    self.sim, s, self.dt, self.bins,
                    cg_iters=self.integrator["cg_iters"],
                    cg_tol=self.integrator["cg_tol"], contact=self.contact,
                    rebin=False, with_stats=True)
                self.counters.cg_iters.append(int(it))
            self.counters.steps += 1
        return out

    def rebin(self, s):
        with record_function(REBIN_SPAN):
            self.counters.rebins += 1
            return b2.rebin_adaptive(self.sim, s, self.bins)

    def chain(self, s, n_steps: int):
        """``n_steps`` of the step from ``s``, rebinning as the flags ask."""
        return b2.adaptive_chain(self.step, self.rebin, s, n_steps)

    def segment(self, s, n_steps: int):
        """A chain, then its end: one synchronisation that reads whether it
        failed (an overflow, or a column that is not finite).  Returns
        (final state, failed)."""
        out = self.chain(s, n_steps)
        with record_function(SYNC_SPAN):
            bad = out.overflow.reshape(()) | \
                ~torch.isfinite(out.cols).all()
            failed = bool(bad)
        return out, failed

    def particles(self, s):
        """(x, v, F) of the state ``s`` in the particles' order."""
        p = b2.unbin_state(s, self.template).particles
        return p["x"], p["v"], p["F"]
