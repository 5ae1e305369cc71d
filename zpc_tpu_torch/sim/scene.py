"""Scenes: fluent construction of MPM simulations (counterpart of
``zpc_tpu/sim/scene.py``).

Objects accumulate on the host (numpy points, per-object velocity and
material); :meth:`Scene.build` packs them into one particle state on the
scene's device, with heterogeneous (E, nu, rho) as per-particle Lamé and
mass fields padded to the capacity, and derives the CFL timestep from the
stiffest object.  Sampling is the JAX package's, point for point
(:mod:`zpc_tpu_torch.geometry.sampling`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.executor import cuda_device
from ..geometry.collider import Collider
from ..geometry.levelset import LevelSet, Sphere
from ..geometry.sampling import sample_lattice, sample_levelset
from ..models import constitutive as cm
from ..models.cfl import timestep_linear_elasticity
from .mpm import MPMSim, MPMState, make_mpm_state

__all__ = ["Scene"]


@dataclasses.dataclass
class _Object:
    positions: np.ndarray
    velocity: np.ndarray
    rho: float
    E: float
    nu: float


class Scene:
    """Fluent scene construction::

        sim, state, dt = (Scene(dx=1 / 128, device=dev)
                          .add_cube([0.5, 0.6, 0.5], 0.25, E=5e4)
                          .add_boundary(ground)
                          .build(block_capacity=4096))

    ``device`` is where :meth:`build` puts the state and the model; None
    means :func:`~zpc_tpu_torch.core.executor.cuda_device`, which raises
    without a card.  Colliders passed to :meth:`add_boundary` must be on
    that device; level sets passed to :meth:`add_levelset_object` are
    evaluated on the CPU (seeding is host work)."""

    def __init__(self, dx: float, ppc: float = 8.0, seed: int = 0, *,
                 device: Optional[torch.device] = None):
        self.dx = float(dx)
        self.ppc = float(ppc)
        self.seed = seed
        self.device = cuda_device() if device is None else device
        self._objects: List[_Object] = []
        self._colliders: List[Collider] = []
        self._gravity = np.array([0.0, -9.8, 0.0], np.float32)
        self._model_cls = cm.FixedCorotated
        self._plasticity = None

    # -- objects --------------------------------------------------------------
    def add_particles(self, x, *, velocity=(0, 0, 0), rho: float = 1e3,
                      E: float = 5e4, nu: float = 0.3) -> "Scene":
        self._objects.append(_Object(
            np.asarray(x, np.float32), np.asarray(velocity, np.float32),
            rho, E, nu))
        return self

    def add_cuboid(self, lo, hi, **kw) -> "Scene":
        pts = sample_lattice(lo, hi, self.dx, self.ppc,
                             seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    def add_cube(self, center, side, **kw) -> "Scene":
        c = np.asarray(center, np.float64)
        h = side / 2.0
        return self.add_cuboid(c - h, c + h, **kw)

    def add_sphere(self, center, radius, **kw) -> "Scene":
        c = np.asarray(center, np.float64)
        ls = Sphere(torch.tensor(c, dtype=torch.float32),
                    torch.tensor(radius, dtype=torch.float32))
        pts = sample_levelset(ls.sdf, c - radius, c + radius, self.dx,
                              self.ppc, seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    def add_levelset_object(self, ls: LevelSet, lo, hi, **kw) -> "Scene":
        pts = sample_levelset(ls.sdf, lo, hi, self.dx, self.ppc,
                              seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    # -- boundaries and globals ----------------------------------------------
    def add_boundary(self, collider: Collider) -> "Scene":
        self._colliders.append(collider)
        return self

    def set_gravity(self, g) -> "Scene":
        self._gravity = np.asarray(g, np.float32)
        return self

    def set_model(self, model_cls) -> "Scene":
        self._model_cls = model_cls
        return self

    def set_plasticity(self, plas) -> "Scene":
        self._plasticity = plas
        return self

    # -- build ----------------------------------------------------------------
    def num_particles(self) -> int:
        return sum(len(o.positions) for o in self._objects)

    def suggest_dt(self, cfl: float = 0.4) -> float:
        """The CFL timestep of the stiffest object (1e-4 for an empty
        scene)."""
        dts = [float(timestep_linear_elasticity(o.E, o.nu, o.rho, self.dx,
                                                cfl))
               for o in self._objects]
        return min(dts) if dts else 1e-4

    def build(self, *, block_capacity: int = 4096,
              capacity: Optional[int] = None, with_Jp: bool = False,
              Jp0: float = 1.0) -> Tuple[MPMSim, MPMState, float]:
        """Pack the objects: ``(sim, state, dt)``.  Per-object (E, nu, rho)
        become per-particle Lamé and mass fields, zero past the particle
        count up to ``capacity``."""
        if not self._objects:
            raise ValueError("empty scene")
        dev = self.device
        xs = np.concatenate([o.positions for o in self._objects])
        vs = np.concatenate([
            np.broadcast_to(o.velocity, (len(o.positions), 3))
            for o in self._objects])
        vol0 = self.dx ** 3 / self.ppc

        def per_particle(value):
            return np.concatenate([
                np.full(len(o.positions), value(o), np.float32)
                for o in self._objects])
        masses = per_particle(lambda o: o.rho * vol0)
        mus = per_particle(lambda o: cm.lame_parameters(o.E, o.nu)[0])
        lams = per_particle(lambda o: cm.lame_parameters(o.E, o.nu)[1])
        st = make_mpm_state(xs, dx=self.dx, device=dev, ppc=self.ppc,
                            block_capacity=block_capacity, velocity=vs,
                            capacity=capacity, with_Jp=with_Jp, Jp0=Jp0)
        cap = st.particles.capacity

        def pad(a):
            return torch.from_numpy(np.concatenate(
                [a, np.zeros(cap - len(a), a.dtype)])).to(dev)
        st = MPMState(st.particles.update(m=pad(masses)), st.grid,
                      st.max_vel)
        sim = MPMSim(model=self._model_cls(pad(mus), pad(lams)),
                     gravity=torch.from_numpy(self._gravity).to(dev),
                     colliders=tuple(self._colliders),
                     plasticity=self._plasticity)
        return sim, st, self.suggest_dt()
