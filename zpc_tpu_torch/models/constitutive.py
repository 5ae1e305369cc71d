"""Constitutive models (counterpart of ``zpc_tpu/models/constitutive.py``),
batched over ``[..., d, d]`` deformation gradients, d = 2 or 3.

Each model is a frozen dataclass of fp32 scalar (or per-particle) tensors
with ``psi`` (energy density), ``first_piola`` (P = dpsi/dF) and
``kirchhoff`` (tau = P F^T, what the MPM transfer scatters).  The
SVD-based models use :func:`zpc_tpu_torch.math.svd.svd3x3` (or, in 2-D,
:func:`~zpc_tpu_torch.math.svd.svd2x2`) in its rotation convention (signed
smallest singular value for inverted elements).
``dP_dF_action`` is the force differential the implicit solver applies:
``torch.func.jvp`` of ``first_piola``, so every ``first_piola`` is free of
in-place writes, host reads and branches on values.  ``linearize(F)``
gives the same differential as a function of dF at a fixed F, with the
SVD of F (for the models whose stress takes one) computed once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..math.svd import _svd3x3_at, polar_newton3x3, svd2x2, svd3x3
from ..math.vecmat import cof3, det3, mm

__all__ = ["lame_parameters", "bcast_scalar", "ElasticModel", "NeoHookean",
           "FixedCorotated", "StvkWithHencky", "EquationOfState",
           "AnisotropicArap"]


def lame_parameters(E: float, nu: float) -> Tuple[float, float]:
    """(mu, lam) from Young's modulus and Poisson ratio."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def bcast_scalar(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar-or-per-particle parameter against ``ref``:
    trailing singleton dims so ``[N]`` parameters align with
    ``[N, 3, 3]`` tensors."""
    v = torch.as_tensor(v)
    extra = ref.dim() - v.dim()
    return v.reshape(v.shape + (1,) * extra) if extra > 0 else v


def _svd(F: torch.Tensor):
    return svd2x2(F) if F.shape[-1] == 2 else svd3x3(F)


def _prod(s: torch.Tensor) -> torch.Tensor:
    """The product of the singular values, written out: torch.prod's
    forward-mode rule runs a cumprod, ~7 ms over 1.2M lanes on the H100,
    twice in every implicit operator application."""
    J = s[..., 0] * s[..., 1]
    return J * s[..., 2] if s.shape[-1] == 3 else J


@dataclasses.dataclass(frozen=True)
class ElasticModel:
    """Base: the Lame parameters; subclasses define ``psi`` and
    ``first_piola``."""

    mu: torch.Tensor
    lam: torch.Tensor

    @classmethod
    def from_young_poisson(cls, E: float, nu: float, *,
                           device: torch.device, **kw) -> "ElasticModel":
        mu, lam = lame_parameters(E, nu)
        return cls(torch.tensor(mu, dtype=torch.float32, device=device),
                   torch.tensor(lam, dtype=torch.float32, device=device),
                   **kw)

    def psi(self, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def first_piola(self, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kirchhoff(self, F: torch.Tensor) -> torch.Tensor:
        """tau = P F^T."""
        return mm(self.first_piola(F), F.transpose(-1, -2))

    def dP_dF_action(self, F: torch.Tensor, dF: torch.Tensor) -> torch.Tensor:
        """The directional derivative dP(F)[dF], by forward-mode autodiff
        of ``first_piola``."""
        return torch.func.jvp(self.first_piola, (F,), (dF,))[1]

    def linearize(self, F: torch.Tensor):
        """``dF -> dP(F)[dF]`` at a fixed F, as :meth:`dP_dF_action` gives
        it, for many dF: the SVD of F is taken here once, and each call
        runs ``torch.func.jvp`` of the stress around it.  The models whose
        stress takes the SVD define ``_piola(F, factors)``, the stress with
        the factors of this F given; the closed-form 2x2 SVD has nothing to
        save."""
        piola = getattr(self, "_piola", None)
        if piola is None or F.shape[-1] == 2:
            return lambda dF: self.dP_dF_action(F, dF)
        factors = svd3x3(F)
        return lambda dF: torch.func.jvp(
            lambda G: piola(G, factors), (F,), (dF,))[1]


def _factors(F, factors):
    """The SVD of F: ``factors`` when the caller has it, else the sweeps
    (the closed form in 2-D)."""
    if factors is None:
        return _svd(F)
    return _svd3x3_at(F, factors)


@dataclasses.dataclass(frozen=True)
class NeoHookean(ElasticModel):
    """psi = mu/2 (tr(F^T F) - d) - mu log J + lam/2 log^2 J."""

    def psi(self, F):
        d = F.shape[-1]
        J = det3(F)
        logJ = torch.log(torch.clamp_min(J, 1e-12))
        I1 = torch.sum(F * F, (-2, -1))
        mu = bcast_scalar(self.mu, I1)
        lam = bcast_scalar(self.lam, I1)
        return 0.5 * mu * (I1 - d) - mu * logJ + 0.5 * lam * logJ * logJ

    def first_piola(self, F):
        J = det3(F)
        logJ = torch.log(torch.clamp_min(J, 1e-12))
        Finv_T = cof3(F) / torch.clamp_min(J, 1e-12)[..., None, None]
        mu = bcast_scalar(self.mu, F)
        lam = bcast_scalar(self.lam, F)
        return mu * (F - Finv_T) + lam * logJ[..., None, None] * Finv_T


@dataclasses.dataclass(frozen=True)
class FixedCorotated(ElasticModel):
    """psi = mu |F - R|^2 + lam/2 (J - 1)^2; P = 2 mu (F - R) + lam (J - 1)
    cof(F).  ``psi``/``first_piola`` take R from the SVD (inverted elements
    in the rotation convention); ``kirchhoff`` from the Newton polar
    iteration in 3-D, as the JAX package's explicit step does, and from
    ``first_piola`` in 2-D."""

    def psi(self, F):
        _, s, _ = _svd(F)
        J = _prod(s)
        mu = bcast_scalar(self.mu, J)
        lam = bcast_scalar(self.lam, J)
        return mu * torch.sum((s - 1.0) ** 2, -1) + \
            0.5 * lam * (J - 1.0) ** 2

    def first_piola(self, F):
        return self._piola(F, None)

    def _piola(self, F, factors):
        U, s, V = _factors(F, factors)
        R = mm(U, V.transpose(-1, -2))
        J = _prod(s)
        return (2.0 * bcast_scalar(self.mu, F)) * (F - R) + \
            (bcast_scalar(self.lam, J) * (J - 1.0))[..., None, None] * cof3(F)

    def kirchhoff(self, F):
        """tau = P F^T with R from the Newton polar iteration (no SVD: the
        corotated stress needs only R, J and cof F); in 2-D, P from the
        closed-form SVD."""
        if F.shape[-1] == 2:
            return super().kirchhoff(F)
        R = polar_newton3x3(F)
        cof = cof3(F)
        J = torch.sum(F[..., :, 0] * cof[..., :, 0], -1)
        P = (2.0 * bcast_scalar(self.mu, F)) * (F - R) + \
            (bcast_scalar(self.lam, J) * (J - 1.0))[..., None, None] * cof
        return mm(P, F.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class StvkWithHencky(ElasticModel):
    """St. Venant-Kirchhoff on the Hencky strain: psi = mu |log s|^2 +
    lam/2 (sum log s)^2 over the principal stretches."""

    def psi(self, F):
        _, s, _ = _svd(F)
        eps = torch.log(torch.clamp_min(s.abs(), 1e-12))
        tr = torch.sum(eps, -1)
        mu = bcast_scalar(self.mu, tr)
        lam = bcast_scalar(self.lam, tr)
        return mu * torch.sum(eps * eps, -1) + 0.5 * lam * tr ** 2

    def first_piola(self, F):
        return self._piola(F, None)

    def _piola(self, F, factors):
        U, s, V = _factors(F, factors)
        s_safe = torch.clamp_min(s.abs(), 1e-12) * torch.where(s < 0, -1.0,
                                                               1.0)
        eps = torch.log(s_safe.abs())
        mu = bcast_scalar(self.mu, eps[..., 0])[..., None]
        lam = bcast_scalar(self.lam, eps[..., 0])[..., None]
        dpsi_dsigma = (2.0 * mu * eps +
                       lam * torch.sum(eps, -1, keepdim=True)) / s_safe
        return mm(U, dpsi_dsigma[..., :, None] * V.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class EquationOfState(ElasticModel):
    """Weakly compressible fluid: p = bulk/gamma (J^-gamma - 1), an
    isotropic Cauchy stress.  ``mu`` is unused; ``lam`` is the bulk
    modulus."""

    gamma: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(7.15))

    @property
    def bulk(self) -> torch.Tensor:
        return self.lam

    def pressure(self, J: torch.Tensor) -> torch.Tensor:
        return self.bulk / self.gamma * (
            torch.pow(torch.clamp_min(J, 1e-6), -self.gamma) - 1.0)

    def psi(self, F):
        J = det3(F)
        g = self.gamma
        # the integral of -p dJ
        return -self.bulk / g * (torch.pow(torch.clamp_min(J, 1e-6), 1.0 - g)
                                 / (1.0 - g) - J)

    def kirchhoff_from_J(self, J: torch.Tensor) -> torch.Tensor:
        """tau = -p J I from the scalar volume ratio (the fluid path)."""
        eye = torch.eye(3, dtype=J.dtype, device=J.device)
        return (-self.pressure(J) * J)[..., None, None] * eye

    def first_piola(self, F):
        return (-self.pressure(det3(F)))[..., None, None] * cof3(F)


@dataclasses.dataclass(frozen=True)
class AnisotropicArap(ElasticModel):
    """Corotated ARAP plus a transversely isotropic fibre: psi =
    mu |F - R|^2 + mu_fiber (|F a| - 1)^2 for the unit fibre ``a`` (one
    direction ``[3]`` or per particle ``[..., 3]``)."""

    fiber: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32([1.0, 0.0, 0.0]))
    mu_fiber: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(0.0))

    def _fa(self, F):
        a = self.fiber.to(F.device)
        if a.dim() < F.dim() - 1:
            a = a.expand(F.shape[:-2] + (3,))
        return torch.einsum("...ij,...j->...i", F, a), a

    def psi(self, F):
        _, s, _ = _svd(F)
        mu = bcast_scalar(self.mu, s[..., 0])
        arap = mu * torch.sum((s - 1.0) ** 2, -1)
        Fa, _ = self._fa(F)
        ell = torch.linalg.vector_norm(Fa, dim=-1)
        muf = bcast_scalar(self.mu_fiber, ell)
        return arap + muf * (ell - 1.0) ** 2

    def first_piola(self, F):
        return self._piola(F, None)

    def _piola(self, F, factors):
        U, s, V = _factors(F, factors)
        R = mm(U, V.transpose(-1, -2))
        P = 2.0 * bcast_scalar(self.mu, F) * (F - R)
        Fa, a = self._fa(F)
        ell = torch.clamp_min(torch.linalg.vector_norm(Fa, dim=-1,
                                                       keepdim=True), 1e-12)
        muf = bcast_scalar(self.mu_fiber, F)
        dpsi = 2.0 * muf * (1.0 - 1.0 / ell)[..., None]
        return P + dpsi * Fa[..., :, None] * a[..., None, :]
