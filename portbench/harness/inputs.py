"""What the benchmark makes from the seed, the configuration and the
traffic, and hands to the program and to the reference alike: the
particles' initial positions and velocities, the obstacle's triangles and
the time step."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["Inputs", "make", "particles", "velocities", "obstacle",
           "timestep", "SEED_MOD"]

SEED_MOD = 2 ** 64


def particles(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """``cfg["particles"]`` positions ``[N, 3]`` float32, uniform in the
    configured cube, drawn on ``device`` by a generator seeded with
    ``seed`` (one call)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % SEED_MOD)
    blk = cfg["block"]
    u = torch.rand((cfg["particles"], 3), generator=g, device=device,
                   dtype=torch.float32)
    lo = torch.tensor(blk["center"], dtype=torch.float32,
                      device=device) - 0.5 * blk["side"]
    return lo + blk["side"] * u


def velocities(traffic: dict, x0: torch.Tensor) -> Optional[torch.Tensor]:
    """The traffic's initial velocity field at ``x0``, float32: the affine
    field ``v = G (x - about)`` of its ``velocity`` entry (``gradient`` G,
    ``about``), or None (at rest) where it has none."""
    spec = traffic.get("velocity")
    if spec is None:
        return None
    f32 = dict(dtype=torch.float32, device=x0.device)
    G = torch.tensor(spec["gradient"], **f32)
    return (x0 - torch.tensor(spec["about"], **f32)) @ G.T


def obstacle(cfg: dict, device: torch.device) -> torch.Tensor:
    """The configuration's obstacle as float32 triangles ``[M, 3, 3]``.
    ``heightfield``: the ``res x res`` grid over ``[lo, hi]^2`` at height
    ``y0 + amp sin(6.2832 x) cos(6.2832 z)``, each cell split into the
    triangles (a, b, c) and (a, c, d), all of the first kind first,
    worked out in float64 and rounded once."""
    ob = cfg["obstacle"]
    if ob["mesh"] != "heightfield":
        raise ValueError(f"unknown obstacle mesh {ob['mesh']!r}")
    xs = torch.linspace(ob["lo"], ob["hi"], ob["res"] + 1,
                        dtype=torch.float64, device=device)
    X, Z = torch.meshgrid(xs, xs, indexing="ij")
    Y = ob["y0"] + ob["amp"] * torch.sin(6.2832 * X) * torch.cos(6.2832 * Z)
    V = torch.stack([X, Y, Z], -1).to(torch.float32)
    a = V[:-1, :-1].reshape(-1, 3)
    b = V[1:, :-1].reshape(-1, 3)
    c = V[1:, 1:].reshape(-1, 3)
    d = V[:-1, 1:].reshape(-1, 3)
    return torch.cat([torch.stack([a, b, c], 1), torch.stack([a, c, d], 1)])


def timestep(cfg: dict) -> float:
    """The configuration's dt: a stated value, or the CFL rule of linear
    elasticity, cfl dx / sqrt((lam + 2 mu) / rho), rounded to float32 (the
    precision the configuration runs in)."""
    rule = cfg["dt"]
    if "value" in rule:
        return float(rule["value"])
    mat = cfg["material"]
    E, nu, rho = mat["E"], mat["nu"], mat["rho"]
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    dt = rule["cfl"] * cfg["dx"] / math.sqrt((lam + 2.0 * mu) / rho)
    return float(torch.tensor(dt, dtype=torch.float32))


@dataclasses.dataclass
class Inputs:
    """One run's inputs: positions ``x0``, velocities ``v0`` (None: at
    rest), the obstacle's triangles ``tri`` (None: the traffic bypasses
    contact) and ``dt``."""
    x0: torch.Tensor
    v0: Optional[torch.Tensor]
    tri: Optional[torch.Tensor]
    dt: float


def make(cfg: dict, traffic: dict, seed: int,
         device: torch.device) -> Inputs:
    x0 = particles(cfg, seed, device)
    tri = obstacle(cfg, device) if traffic["contact"] else None
    return Inputs(x0, velocities(traffic, x0), tri, timestep(cfg))
