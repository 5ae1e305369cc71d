"""Plasticity models (counterpart of ``zpc_tpu/models/plasticity.py``):
return mappings on the principal stretches of the trial deformation
gradient, batched over ``[..., 3, 3]``.

Each model's ``project`` takes the trial F and its own state and returns
``(F_projected, state')``; the signatures are the JAX package's
(``SnowPlasticity.project(F, Jp)``, ``DruckerPrager.project(F, logJp)``,
``VonMisesCapped.project(F, state, strain_rate)``,
``AssociativeVonMises.project(F, model, state)``, ...).  Every model
decomposes F with :func:`zpc_tpu_torch.math.svd.svd3x3` in the rotation
convention, so the signed smallest stretch of an inverted element enters
``Jp`` as it does in the JAX package.  Parameters are fp32 scalar tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..math.svd import svd3x3
from ..math.vecmat import mm33

__all__ = ["SnowPlasticity", "VonMisesCapped", "DruckerPrager", "NACC",
           "NonAssociativeVonMises", "AssociativeVonMises"]


def _f32(v):
    return dataclasses.field(
        default_factory=lambda: torch.tensor(v, dtype=torch.float32))


def _compose(U, s, V):
    """U diag(s) V^T."""
    return mm33(U, s[..., :, None] * V.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class SnowPlasticity:
    """Stomakhin snow: clamp the stretches to [1 - theta_c, 1 + theta_s],
    move the clamped volume into Jp, harden by exp(xi (1 - Jp))."""

    theta_c: torch.Tensor = _f32(2.5e-2)
    theta_s: torch.Tensor = _f32(7.5e-3)
    xi: torch.Tensor = _f32(10.0)
    jp_min: torch.Tensor = _f32(0.1)
    jp_max: torch.Tensor = _f32(10.0)

    def project(self, F_trial, Jp):
        U, s, V = svd3x3(F_trial)
        s_clamped = torch.clamp(s, 1.0 - self.theta_c, 1.0 + self.theta_s)
        Jp_new = torch.clamp(Jp * torch.prod(s, -1) /
                             torch.prod(s_clamped, -1),
                             self.jp_min, self.jp_max)
        return _compose(U, s_clamped, V), Jp_new

    def hardening(self, Jp):
        """Multiplier on (mu, lam)."""
        return torch.exp(self.xi * (1.0 - Jp))


@dataclasses.dataclass(frozen=True)
class VonMisesCapped:
    """Von Mises yield on the Hencky strain deviator, with volumetric caps
    ``tr(eps)`` in ``[-k1_compress, k1_stretch] / (3 lam + 2 mu)`` (inf:
    uncapped) and Cowper-Symonds rate hardening ``1 + (r / c)^p`` when a
    ``strain_rate`` is given."""

    yield_stress: torch.Tensor = _f32(1e4)
    mu: torch.Tensor = _f32(1e5)
    lam: torch.Tensor = _f32(0.0)
    k1_compress: torch.Tensor = _f32(math.inf)
    k1_stretch: torch.Tensor = _f32(math.inf)
    rate_c: torch.Tensor = _f32(1.0)
    rate_p: torch.Tensor = _f32(1.0)

    def project(self, F_trial, state=None, strain_rate=None):
        d = 3
        U, s, V = svd3x3(F_trial)
        eps = torch.log(torch.clamp_min(s.abs(), 1e-12))
        tr = torch.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = torch.linalg.vector_norm(dev, dim=-1)
        ys = self.yield_stress
        if strain_rate is not None:
            ys = ys * (1.0 + (strain_rate / self.rate_c) ** self.rate_p)
        # yield: 2 mu |dev| <= sqrt(2/3) sigma_y
        limit = math.sqrt(2.0 / 3.0) * ys / (2.0 * self.mu)
        scale = torch.where(dev_norm > limit,
                            limit / torch.clamp_min(dev_norm, 1e-12), 1.0)
        eps_new = (tr / d)[..., None] + dev * scale[..., None]
        denom = d * self.lam + 2.0 * self.mu
        cap_hi = self.k1_stretch / denom
        cap_lo = -self.k1_compress / denom
        shift = torch.where(tr > cap_hi, (cap_hi - tr) / d,
                            torch.where(tr < cap_lo, (cap_lo - tr) / d, 0.0))
        eps_new = eps_new + shift[..., None]
        return _compose(U, torch.exp(eps_new), V), state


@dataclasses.dataclass(frozen=True)
class DruckerPrager:
    """Non-associative Drucker-Prager sand: the Hencky strain (with the
    stored plastic volume ``logJp`` restored) projected onto the cone,
    expansion projected to the tip."""

    mu: torch.Tensor
    lam: torch.Tensor
    friction_angle: torch.Tensor = _f32(30.0)         # degrees
    cohesion: torch.Tensor = _f32(0.0)

    @property
    def alpha(self):
        s = torch.sin(self.friction_angle * (math.pi / 180.0))
        return math.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)

    def project(self, F_trial, logJp):
        d = 3
        U, s, V = svd3x3(F_trial)
        eps = torch.log(torch.clamp_min(s.abs(), 1e-12)) + \
            (logJp / d)[..., None]
        tr = torch.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = torch.linalg.vector_norm(dev, dim=-1)
        expanding = tr > 0.0
        dg = dev_norm + self.alpha * (d * self.lam + 2.0 * self.mu) / \
            (2.0 * self.mu) * tr - self.cohesion
        yielding = dg > 0.0
        shear = yielding & ~expanding
        scale = torch.where(shear,
                            1.0 - dg / torch.clamp_min(dev_norm, 1e-12), 1.0)
        scale = torch.clamp_min(scale, 0.0)
        # shear yield keeps the volumetric part, the tip drops all strain,
        # inside the cone nothing moves
        eps_new = torch.where(expanding[..., None], torch.zeros_like(eps),
                              dev * scale[..., None] + (tr / d)[..., None])
        eps_new = torch.where((~yielding & ~expanding)[..., None], eps,
                              eps_new)
        dlogJp = torch.sum(eps, -1) - torch.sum(eps_new, -1)
        return _compose(U, torch.exp(eps_new), V), logJp + dlogJp


@dataclasses.dataclass(frozen=True)
class NACC:
    """Non-associated Cam-Clay: an elliptic yield surface in (p, q) with
    hardening driven by ``logJp``."""

    mu: torch.Tensor
    lam: torch.Tensor
    beta: torch.Tensor = _f32(0.5)
    M: torch.Tensor = _f32(1.85)
    xi: torch.Tensor = _f32(0.8)
    hardening_on: bool = True

    def project(self, F_trial, logJp):
        d = 3
        U, s, V = svd3x3(F_trial)
        eps = torch.log(torch.clamp_min(s.abs(), 1e-12))
        tr = torch.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = torch.linalg.vector_norm(dev, dim=-1)
        kappa = self.lam + 2.0 * self.mu / d
        p0 = kappa * (1e-5 + torch.sinh(self.xi *
                                        torch.clamp_min(-logJp, 0.0)))
        p = -kappa * tr                          # pressure (compression +)
        q = math.sqrt(2.0) * self.mu * dev_norm  # shear measure
        y = (1.0 + 2.0 * self.beta) * q * q + \
            self.M * self.M * (p + self.beta * p0) * (p - p0)
        case_cap = p > p0                        # compression cap
        case_tip = p < -self.beta * p0           # tension tip
        q_max = self.M * torch.sqrt(torch.clamp_min(
            -(p + self.beta * p0) * (p - p0), 0.0) / (1.0 + 2.0 * self.beta))
        scale = torch.where((y > 0.0) & ~case_cap & ~case_tip,
                            q_max / torch.clamp_min(q, 1e-12), 1.0)
        eps_new = dev * scale[..., None] + (tr / d)[..., None]
        eps_cap = (-p0 / kappa / d)[..., None].expand(eps.shape)
        eps_tip = ((self.beta * p0) / kappa / d)[..., None].expand(eps.shape)
        eps_new = torch.where(case_cap[..., None], eps_cap, eps_new)
        eps_new = torch.where(case_tip[..., None], eps_tip, eps_new)
        dlogJp = torch.where(case_cap | case_tip,
                             tr - torch.sum(eps_new, -1), 0.0)
        logJp_new = logJp + dlogJp if self.hardening_on else logJp + 0.0
        return _compose(U, torch.exp(eps_new), V), logJp_new


@dataclasses.dataclass(frozen=True)
class NonAssociativeVonMises:
    """Von Mises return map on the trial left Cauchy-Green tensor: yield on
    the deviator of ``mu J^(-2/3) dev(b_hat)`` against ``tau_y +
    hardening_coeff * alpha``, projected by shifting ``b_hat`` along the
    deviator."""

    tau_y: torch.Tensor = _f32(1e4)
    mu: torch.Tensor = _f32(1e5)
    alpha: torch.Tensor = _f32(0.0)
    hardening_coeff: torch.Tensor = _f32(0.0)

    def project(self, F_trial, state=None):
        d = 3
        U, s, V = svd3x3(F_trial)
        s = torch.clamp_min(s.abs(), 1e-12)
        scaled_tau = math.sqrt(2.0 / (6.0 - d)) * \
            (self.tau_y + self.hardening_coeff * self.alpha)
        b_hat = s * s
        J = torch.prod(s, -1)
        scaled_mu = self.mu * J ** (-2.0 / d)
        dev_b = b_hat - torch.mean(b_hat, -1, keepdim=True)
        s_hat = scaled_mu[..., None] * dev_b
        s_norm = torch.linalg.vector_norm(s_hat, dim=-1)
        y = s_norm - scaled_tau
        z = y / torch.clamp_min(scaled_mu, 1e-30)
        b_new = b_hat - (z / torch.clamp_min(s_norm, 1e-30))[..., None] * \
            s_hat
        s_proj = torch.sqrt(torch.clamp_min(b_new, 1e-12))
        s_new = torch.where((y >= 1e-4)[..., None], s_proj, s)
        return _compose(U, s_new, V), state


@dataclasses.dataclass(frozen=True)
class AssociativeVonMises:
    """Associative von Mises return map in principal Kirchhoff-stress
    space: principal Cauchy stress ``c = dpsi/dsigma * sigma / J`` from the
    elastic model's energy (autodiff through ``model.psi``), flow direction
    ``P c / sqrt(2 c.Pc)`` with ``P = 3I - 11^T``, and ``iters`` damped
    Newton rounds on the scalar residual with an exact directional
    derivative, batched over every element at once."""

    initial_stress: torch.Tensor = _f32(1e4)
    iters: int = 10

    def project(self, F_trial, model, state=None):
        P = 3.0 * torch.eye(3, dtype=F_trial.dtype, device=F_trial.device) \
            - 1.0

        def residual(sig):
            g = torch.func.grad(
                lambda x: model.psi(torch.diag_embed(x)).sum())(sig)
            c = g * sig / torch.prod(sig, -1, keepdim=True)
            Pc = c @ P                            # P is symmetric
            vm = torch.sqrt(torch.clamp_min(0.5 * (c * Pc).sum(-1), 1e-30))
            return vm - self.initial_stress, c

        def flow(c):
            Pc = c @ P
            return Pc / torch.sqrt(torch.clamp_min(
                2.0 * (c * Pc).sum(-1), 1e-30))[..., None]

        U, sig, V = svd3x3(F_trial)
        sig = torch.clamp_min(sig.abs(), 1e-6)
        res0, _ = residual(sig)
        s = sig
        for _ in range(self.iters):
            res, c = residual(s)
            n = flow(c)
            _, drds = torch.func.jvp(lambda t: residual(t)[0], (s,), (n,))
            step = res / torch.where(drds.abs() > 1e-30, drds, 1e-30)
            s_new = torch.clamp_min(s - step[..., None] * n, 1e-6)
            # bidirectional: an overshoot into the surface steps back out
            # on the next round
            far = res.abs() > 1e-6 * self.initial_stress
            s = torch.where(far[..., None], s_new, s)
        s = torch.where((res0 > 0.0)[..., None], s, sig)
        return _compose(U, s, V), state
