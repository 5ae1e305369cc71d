"""Scenes built from numpy inputs, identical to the JAX package's.

:func:`mpm_block` is ``examples/mpm_block.py:build`` line for line: the same
``default_rng(7)`` positions, material, colliders and CFL timestep, so a
JAX run and a port run start from the same particles.  :func:`dam_break`
is the weakly compressible dam break of ``benchmarks/run_all.py:
bench_fluid``, :func:`materials` the four material scenes of
``examples/materials.py:build``, :func:`lbvh_boxes` the LBVH
broad-phase scene of ``benchmarks/run_all.py:bench_bvh``,
:func:`implicit_block` and :func:`implicit_config` the implicit-MPM scene
of ``bench_implicit``, :func:`terrain_mesh` its mesh-contact heightfield
(``benchmarks/run_all.py:_terrain_mesh``), :func:`floor_mesh` the
two-triangle floor of ``tests/test_contact_implicit.py`` and
:func:`contact_block` the two together, :func:`poisson_rhs` with
:func:`laplace` the CG Poisson problem of ``bench_poisson``,
:func:`readme_scene` the README's Quick start through
:class:`~zpc_tpu_torch.sim.scene.Scene`, and :func:`discs_2d` with
:func:`discs_2d_config` the two falling discs of ``examples/mpm2d.py``,
:func:`cloth_two_layer` the two-layer self-contact drop of
``benchmarks/run_all.py:bench_cloth``, :func:`cloth_drape` the cloth of
``examples/cloth_drape.py`` and :func:`tet_box_hanging` the hanging block
of ``tests/test_fem.py``.  Every scene is built on the caller's device
(for the cloth and FEM scenes, None means the card).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import dataclasses

import numpy as np
import torch

from .core.executor import cuda_device
from .geometry.collider import Collider, ColliderType
from .geometry.levelset import ComplementLevelSet, Cuboid, HalfSpace
from .models.cfl import timestep_linear_elasticity
from .models.constitutive import (EquationOfState, FixedCorotated,
                                  NeoHookean, StvkWithHencky,
                                  lame_parameters)
from .models.plasticity import DruckerPrager, SnowPlasticity
from .sim.cloth import (ClothSim, build_grid_stencil, build_incidence,
                        make_cloth_grid)
from .sim.contact_implicit import MeshContact
from .sim.fem import FemSim, make_tet_box
from .sim.fluid import make_fluid_state
from .sim.mpm import MPMSim, MPMState, make_mpm_state
from .sim.mpm_binned2 import K, BinnedConfig2
from .sim.scene import Scene

__all__ = ["mpm_block", "dam_break", "dam_break_config", "materials",
           "MATERIALS", "lbvh_boxes", "implicit_block", "implicit_config",
           "terrain_mesh", "floor_mesh", "contact_block", "poisson_rhs",
           "laplace", "readme_scene", "discs_2d", "discs_2d_config",
           "cloth_two_layer", "cloth_drape", "tet_box_hanging"]

MATERIALS = ("jello", "snow", "sand", "fluid")


def mpm_block(n_particles: int, dx: float, device: torch.device,
              block_capacity: int = 4096) -> Tuple[MPMSim, MPMState, float]:
    """The elastic block benchmark scene: FixedCorotated (E 5e4, nu 0.3,
    rho 1e3, 8 ppc), a sticky ground plane at y = 0.05 and sticky box
    walls at 0.02 / 0.98.  Returns ``(sim, state, dt)`` with the CFL-0.4
    timestep."""
    rng = np.random.default_rng(7)
    # cube of side 0.25 centred in the unit domain, lifted by 0.2 in y
    L = 0.25
    x = rng.uniform(0.5 - L / 2, 0.5 + L / 2,
                    (n_particles, 3)).astype(np.float32)
    x[:, 1] += 0.2
    st = make_mpm_state(x, dx=dx, device=device, rho=1e3, ppc=8.0,
                        block_capacity=block_capacity)
    E, nu = 5e4, 0.3
    model = FixedCorotated.from_young_poisson(E, nu, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ground = Collider(HalfSpace(torch.tensor([0.0, 0.05, 0.0], **f32),
                                torch.tensor([0.0, 1.0, 0.0], **f32)),
                      ColliderType.sticky)
    walls = Collider(ComplementLevelSet(Cuboid(torch.full((3,), 0.02, **f32),
                                               torch.full((3,), 0.98, **f32))),
                     ColliderType.sticky)
    sim = MPMSim(model=model, gravity=torch.tensor([0.0, -9.8, 0.0], **f32),
                 colliders=(ground, walls))
    dt = float(timestep_linear_elasticity(E, nu, 1e3, dx, cfl=0.4))
    return sim, st, dt


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def dam_break_config(n: int) -> BinnedConfig2:
    """The dam break's bin budget, derived from ``n``: ``ceil(1.25 n / K)``
    bins (2,560 at 262,144 particles, 10,240 at 1,048,576, the JAX bench's
    two values, and enough lanes between them, where the bench's
    two-point choice runs short), at least 64 (below ~6,500 particles the
    K-padding of the column's partly filled blocks outgrows a quarter of
    the lanes: 4,096 particles fill 43 bins), and a dilated table of
    4,096 blocks up to 524,288 particles, 8,192 above."""
    return BinnedConfig2(bins_capacity=max(math.ceil(1.25 * n / K), 64),
                         block_capacity=8192 if n > 524_288 else 4096)


def dam_break(n: int, device: torch.device
              ) -> Tuple[MPMSim, MPMState, float, BinnedConfig2]:
    """The weakly compressible dam break: a jittered-grid column of 8
    particles per cell (``default_rng(11)``, two per cell per axis at +-0.1
    dx) of ``side_c = round((n / 8)^(1/3))`` cells per axis, offset 0.05,
    dx = 1/128; equation of state mu 0, lam 8e4, gamma 7; a slip tank
    ``ComplementLevelSet(Cuboid(0.02, 0.98))``; dt 2e-4.  Returns
    ``(sim, fluid state, dt, BinnedConfig2)``."""
    rng = np.random.default_rng(11)
    dx = 1.0 / 128
    side_c = round((n / 8) ** (1 / 3))
    cell = np.arange(side_c)
    ci = np.stack(np.meshgrid(cell, cell, cell, indexing="ij"),
                  -1).reshape(-1, 3)
    offs = np.stack(np.meshgrid(*([np.asarray([0.25, 0.75])] * 3),
                                indexing="ij"), -1).reshape(-1, 3)
    x = (ci[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    x = (x + rng.uniform(-0.1, 0.1, x.shape)) * dx + 0.05
    x = x.astype(np.float32)[:n]
    cfg = dam_break_config(n)
    st = make_fluid_state(x, dx=dx, device=device, rho=1e3,
                          block_capacity=cfg.block_capacity)
    tank = Collider(ComplementLevelSet(Cuboid(
        torch.full((3,), 0.02, dtype=torch.float32, device=device),
        torch.full((3,), 0.98, dtype=torch.float32, device=device))),
        ColliderType.slip)
    sim = MPMSim(model=EquationOfState(_f32(0.0, device), _f32(8e4, device),
                                       _f32(7.0, device)),
                 gravity=_f32([0.0, -9.8, 0.0], device), colliders=(tank,))
    return sim, st, 2e-4, cfg


def materials(material: str, n: int = 32768, dx: float = 1.0 / 64, *,
              device: torch.device) -> Tuple[MPMSim, MPMState, float]:
    """One of :data:`MATERIALS` on ``device``: ``default_rng(1)``
    positions in a cube of side 0.2 centred at 0.5, lifted by 0.15, on a
    slip ground plane at y = 0.1 with friction 0.4.  jello:
    FixedCorotated (E 5e4, nu 0.3), dt 2e-4; snow: FixedCorotated (E
    1.4e5, nu 0.2) with SnowPlasticity and Jp = 1, dt 1e-4; sand:
    StvkWithHencky (E 3.5e5, nu 0.3) with Drucker-Prager at 35 degrees
    and logJp = 0, dt 1e-4; fluid: EquationOfState (lam 2e4, gamma 7.15)
    on F, dt 2e-4.  Returns ``(sim, state, dt)``."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.4, 0.6, (n, 3)).astype(np.float32)
    x[:, 1] += 0.15
    ground = Collider(HalfSpace(_f32([0.0, 0.1, 0.0], device),
                                _f32([0.0, 1.0, 0.0], device)),
                      ColliderType.slip, friction=0.4)
    with_Jp, Jp0 = False, 1.0
    plasticity = None
    if material == "jello":
        model = FixedCorotated.from_young_poisson(5e4, 0.3, device=device)
        dt = 2e-4
    elif material == "snow":
        model = FixedCorotated.from_young_poisson(1.4e5, 0.2, device=device)
        plasticity = SnowPlasticity(*(_f32(v, device) for v in
                                      (2.5e-2, 7.5e-3, 10.0, 0.1, 10.0)))
        with_Jp, Jp0 = True, 1.0
        dt = 1e-4
    elif material == "sand":
        mu, lam = (_f32(v, device) for v in lame_parameters(3.5e5, 0.3))
        model = StvkWithHencky(mu, lam)
        plasticity = DruckerPrager(mu, lam, _f32(35.0, device),
                                   _f32(0.0, device))
        with_Jp, Jp0 = True, 0.0                       # logJp
        dt = 1e-4
    elif material == "fluid":
        model = EquationOfState(_f32(0.0, device), _f32(2e4, device),
                                _f32(7.15, device))
        dt = 2e-4
    else:
        raise ValueError(f"unknown material {material!r}, not one of "
                         f"{MATERIALS}")
    st = make_mpm_state(x, dx=dx, device=device, rho=1e3,
                        block_capacity=4096, with_Jp=with_Jp, Jp0=Jp0)
    sim = MPMSim(model=model, gravity=_f32([0.0, -9.8, 0.0], device),
                 colliders=(ground,), plasticity=plasticity)
    return sim, st, dt


def lbvh_boxes(n: int, device: torch.device, seed: int = 0,
               half: float = 0.002
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n`` boxes of half-extent ``half`` on each axis around centres drawn
    uniformly in the unit cube by ``default_rng(seed)`` (float32), as
    ``bench_bvh`` makes them.  Returns ``(lo, hi, centers)`` on
    ``device``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), half, np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (c - h, c + h, c))


def implicit_block(n: int, device: torch.device
                   ) -> Tuple[MPMSim, MPMState, float]:
    """The implicit-MPM scene of ``benchmarks/run_all.py:bench_implicit``:
    :func:`mpm_block` at dx = 1/128 (a block table of 8,192 above 500,000
    particles, else 4,096), stepped at dt = 5e-4, far above its explicit
    CFL step.  Returns ``(sim, state, dt)``."""
    sim, st, _ = mpm_block(n, 1.0 / 128, device,
                           block_capacity=8192 if n > 500_000 else 4096)
    return sim, st, 5e-4


def implicit_config(n: int) -> BinnedConfig2:
    """``bench_implicit``'s bin budget: 9,216 bins and an 8,192-block
    table above 500,000 particles, else 2,560 and 2,048 (its
    ``chunk_bins`` restructures the TPU computation only and is
    dropped)."""
    big = n > 500_000
    return BinnedConfig2(bins_capacity=9216 if big else 2560,
                         block_capacity=8192 if big else 2048)


def terrain_mesh(res: int, device: torch.device, y0: float = 0.56,
                 amp: float = 0.02) -> torch.Tensor:
    """``bench_implicit``'s contact obstacle: a ``res x res`` heightfield
    ``y = y0 + amp sin(6.2832 x) cos(6.2832 z)`` over ``[0, 1]^2`` as
    ``2 res^2`` triangles ``[2 res^2, 3, 3]`` (float32; each quad's
    (a, b, c) triangles first, then its (a, c, d) ones)."""
    xs = np.linspace(0.0, 1.0, res + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = y0 + amp * np.sin(6.2832 * X) * np.cos(6.2832 * Z)
    V = np.stack([X, Y, Z], -1).astype(np.float32)
    a = V[:-1, :-1].reshape(-1, 3)
    b = V[1:, :-1].reshape(-1, 3)
    c = V[1:, 1:].reshape(-1, 3)
    d = V[:-1, 1:].reshape(-1, 3)
    tri = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return torch.from_numpy(tri).to(device)


def floor_mesh(y: float, lo: float, hi: float,
               device: torch.device) -> torch.Tensor:
    """Two triangles spanning the square ``[lo, hi]^2`` of the plane at
    height ``y``, ``[2, 3, 3]`` float32."""
    a, b, c, d = ([lo, y, lo], [hi, y, lo], [hi, y, hi], [lo, y, hi])
    return torch.tensor([[a, b, c], [a, c, d]], dtype=torch.float32,
                        device=device)


def contact_block(n: int, tri: torch.Tensor, device: torch.device
                  ) -> Tuple[MPMSim, MPMState, float, BinnedConfig2,
                             MeshContact]:
    """``bench_implicit``'s contact rows: :func:`implicit_block` and
    :func:`implicit_config` over the mesh ``tri`` with the bench's
    ``MeshContact.build(tri, dhat=0.01, kappa=10.0, max_tris=8)``.  Returns
    ``(sim, state, dt, config, contact)``."""
    sim, st, dt = implicit_block(n, device)
    mc = MeshContact.build(tri.to(device), 0.01, 10.0, max_tris=8)
    return sim, st, dt, implicit_config(n), mc


def poisson_rhs(n: int, device: torch.device) -> torch.Tensor:
    """The right-hand side of ``bench_poisson``: ``default_rng(0)``
    standard normals ``[n, n, n]`` in float32."""
    b = np.random.default_rng(0).standard_normal((n, n, n))
    return torch.from_numpy(b.astype(np.float32)).to(device)


def laplace(u: torch.Tensor) -> torch.Tensor:
    """``bench_poisson``'s matrix-free 7-point operator, 6 u minus the six
    axis neighbours, zero outside the box (each neighbour subtracted in
    the bench's order)."""
    out = 6.0 * u
    for d in range(3):
        hi = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi[d], lo[d] = slice(1, None), slice(None, -1)
        out[tuple(lo)] -= u[tuple(hi)]
        out[tuple(hi)] -= u[tuple(lo)]
    return out


def readme_scene(dx: float, device: torch.device, sphere: bool = False
                 ) -> Tuple[MPMSim, MPMState, float]:
    """The README's Quick start: a cube of side 0.25 at (0.5, 0.6, 0.5) with
    E = 5e4 (the lattice of 8 ppc: 262,144 particles at dx = 1/128) over a
    sticky ground at y = 0.05, built by :class:`Scene` with
    ``block_capacity=4096``; ``sphere`` adds a ball of radius 0.1 at (0.5,
    0.3, 0.5) below it (level-set seeding).  Returns ``(sim, state,
    dt)``."""
    ground = Collider(HalfSpace(_f32([0.0, 0.05, 0.0], device),
                                _f32([0.0, 1.0, 0.0], device)),
                      ColliderType.sticky)
    scene = Scene(dx=dx, device=device).add_cube([0.5, 0.6, 0.5], 0.25,
                                                 E=5e4)
    if sphere:
        scene.add_sphere([0.5, 0.3, 0.5], 0.1)
    return scene.add_boundary(ground).build(block_capacity=4096)


def discs_2d(draws: int, dx: float, device: torch.device,
             block_capacity: int = 2048) -> Tuple[MPMSim, MPMState]:
    """``examples/mpm2d.py``'s scene: ``default_rng(3)``, ``draws // 2``
    uniform draws in [-0.1, 0.1]^2 per disc, the ones inside radius 0.1
    kept around (0.35, 0.6) and (0.65, 0.75); FixedCorotated E 5e4, nu
    0.3; a slip ground at y = 0.1 with friction 0.2.  The example runs
    8,192 draws at dx = 1/128 and dt = 1e-4."""
    rng = np.random.default_rng(3)
    pts = []
    for c in ([0.35, 0.6], [0.65, 0.75]):
        p = rng.uniform(-0.1, 0.1, (draws // 2, 2))
        pts.append(p[np.linalg.norm(p, axis=1) < 0.1] + c)
    x = np.concatenate(pts).astype(np.float32)
    ground = Collider(HalfSpace(_f32([0.0, 0.1], device),
                                _f32([0.0, 1.0], device)),
                      ColliderType.slip, friction=0.2)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(5e4, 0.3,
                                                         device=device),
                 gravity=_f32([0.0, -9.8], device), colliders=(ground,))
    st = make_mpm_state(x, dx=dx, device=device,
                        block_capacity=block_capacity)
    return sim, st


def discs_2d_config(capacity: int, block_capacity: Optional[int] = None
                    ) -> BinnedConfig2:
    """The example's bins, ``max(256, capacity // 128 * 4)``: a 4^2 block
    at 4 ppc fills half a bin."""
    return BinnedConfig2(bins_capacity=max(256, capacity // K * 4),
                         block_capacity=block_capacity)


def cloth_two_layer(nx: int, device: Optional[torch.device] = None
                    ) -> Tuple[ClothSim, torch.Tensor]:
    """The bench's two-layer self-contact drop (``bench_cloth`` and
    ``benchmarks/probe_r5_cloth_window.py:build``): two ``nx x nx`` grids
    at spacing ``0.6 / nx`` in one :class:`ClothSim`, layer A pinned at
    height 0.2, layer B free above it by ``1.6 spacing`` and shifted half
    a cell so its vertices land over A's triangles; ``dhat = 0.8533
    spacing`` (exactly ``0.008 * 64 / nx``: 0.015 and 0.008 at nx = 64),
    ground far below, k_stretch 2e2, k_bend 1e-4, vertex mass 0.01; both
    grids stenciled and the incidence tables built.  ``2 nx^2`` vertices,
    ``4 (nx - 1)^2`` triangles.  Returns ``(sim, x0)``."""
    dev = cuda_device() if device is None else device
    spacing = 0.6 / nx
    gap, dhat = 0.015 * 64 / nx, 0.008 * 64 / nx
    simA, xA = make_cloth_grid(nx, nx, spacing, height=0.2, dhat=dhat,
                               ground_off=-10.0, k_stretch=2e2,
                               k_bend=1e-4, mass=0.01, device=dev)
    N = xA.shape[0]
    xB = xA + xA.new_tensor([0.5 * spacing, gap, 0.5 * spacing])
    free = torch.cat([torch.zeros(N, dtype=torch.bool, device=dev),
                      torch.ones(N, dtype=torch.bool, device=dev)])
    two = lambda a, shift=0: torch.cat([a, a + shift])
    sim = dataclasses.replace(
        simA, tris=two(simA.tris, N), edges=two(simA.edges, N),
        hinges=two(simA.hinges, N), rest_len=two(simA.rest_len),
        rest_angle=two(simA.rest_angle), mass=two(simA.mass), free=free,
        edge_inc=None, hinge_inc=None, stencil=None)
    sim = build_grid_stencil(build_incidence(sim),
                             ((0, nx, nx), (N, nx, nx)))
    return sim, torch.cat([xA, xB])


def cloth_drape(nx: int = 24, ny: int = 24, pin: bool = False,
                device: Optional[torch.device] = None
                ) -> Tuple[ClothSim, torch.Tensor]:
    """``examples/cloth_drape.py``'s cloth: ``nx x ny`` at spacing 0.02 and
    height 0.3, k_stretch 5e2, k_bend 5e-5, vertex mass 0.005, a ground
    barrier (dhat 0.02, kappa 2) with friction 0.4; ``pin`` pins the
    corners 0 and ``(nx - 1) ny``.  The example steps it with dt 0.008, 4
    substeps per frame."""
    pins = (0, (nx - 1) * ny) if pin else ()
    return make_cloth_grid(nx, ny, 0.02, height=0.3, pinned=pins,
                           k_stretch=5e2, k_bend=5e-5, mass=0.005,
                           dhat=0.02, kappa=2.0, mu=0.4, device=device)


def tet_box_hanging(n=(3, 5, 3), device: Optional[torch.device] = None,
                    model=None) -> Tuple[FemSim, torch.Tensor, list]:
    """``tests/test_fem.py``'s hanging block at ``n`` vertices per axis (an
    int for a cube): its width fixed at 0.1 (spacing ``0.1 / (nx - 1)``,
    the test's 0.05 at its 3 x 5 x 3), origin (0, 0.3, 0), density 1e3,
    the top row of vertices pinned; ``model`` defaults to the test's
    NeoHookean (E 5e4, nu 0.3).  Returns ``(sim, x0, pinned ids)``."""
    dev = cuda_device() if device is None else device
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    if model is None:
        model = NeoHookean.from_young_poisson(5e4, 0.3, device=dev)
    top = [i * ny * nz + (ny - 1) * nz + k
           for i in range(nx) for k in range(nz)]
    sim, x0 = make_tet_box(nx, ny, nz, 0.1 / (nx - 1), model=model,
                           density=1e3, origin=(0.0, 0.3, 0.0), pinned=top,
                           device=dev)
    return sim, x0, top
