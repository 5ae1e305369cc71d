"""Plain reference of the benchmark's MPM scenes: quadratic-B-spline APIC
MPM on one dense grid over the unit cube, in plain PyTorch.

It imports nothing of the program under test.  It takes the configuration
(a dict read from ``portbench/configs/<name>.json``) and what the
benchmark made and hands to both sides: the particles' initial positions
(and velocities, where the traffic sets them in motion), the obstacle's
triangles and the time step.  It works out everything else itself: the
particle state, the grid, the colliders, the stress, the implicit system
and the contact barrier.  ``dtype`` sets the
precision of every tensor it holds: float64 for the reference, bfloat16
for the control (the configuration states float32).

The explicit step: FixedCorotated Kirchhoff stress with R the polar
factor (determinant-scaled Newton iteration run to convergence), P2G of
mass and APIC momentum with the stress term, grid velocity under gravity,
sticky colliders at the nodes, massless nodes zeroed, G2P of v and C,
F <- (I + dt C) F, x <- x + dt v.

The implicit step: the same right-hand side plus the barrier force, the
predictor v* = (p + dt f) / m + dt g, Dirichlet nodes where a collider
changes v*, and the linearised system (M + dt^2 K + dt^2 H_c) v = M v*
solved by mass-Jacobi PCG to ``solve_rtol`` of the right-hand side.  The
force differential dP(F)[dF] is written out: dR from the polar factor's
derivative, dJ = cof F : dF, and the cofactor's derivative as the
difference quotient (cof(F + dF) - cof(F - dF)) / 2, which is exact
because the cofactor is quadratic.

The barrier: for every particle and every triangle of the obstacle, the
closest point, d^2, and the IPC barrier b(d^2) = -kappa (d^2 - dhat^2)^2
log(d^2 / dhat^2) where 0 < d^2 < dhat^2; force -2 b' (p - c) and the
Gauss-Newton Hessian 4 max(b'', 0) (p - c)(p - c)^T, summed over the
triangles, taken at the step's start positions.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DenseMPM", "run"]

_OFFS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


def _cof(F):
    """Cofactor matrix of [..., 3, 3] (cof F = det F F^-T)."""
    a = F
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return torch.stack([torch.stack([c00, c01, c02], -1),
                        torch.stack([c10, c11, c12], -1),
                        torch.stack([c20, c21, c22], -1)], -2)


def _mm(a, b):
    """[..., 3, 3] @ [..., 3, 3] as sums of products (no matmul library
    call, so no precision switch of one reaches it)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _polar(F, iters: int, eps: float = 1e-6):
    """Orthogonal polar factor by determinant-scaled Newton iteration
    (``det`` held away from 0, so a degenerate F stays finite)."""
    X = F
    for _ in range(iters):
        cof = _cof(X)
        det = (X[..., :, 0] * cof[..., :, 0]).sum(-1)
        det = torch.where(det.abs() < eps, eps * torch.where(det < 0, -1, 1),
                          det).to(X.dtype)
        g = det.abs() ** (-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X +
                   cof / (det * g)[..., None, None])
    return X


def _skew_axial(W):
    """axial vector w of a skew matrix [w]x."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _cross_matrix(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _closest_on_triangle(p, a, b, c):
    """Closest point on triangle abc to p (Ericson's region tests)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp = p - b
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    cp = p - c
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    tiny = torch.finfo(p.dtype).tiny
    den = (va + vb + vc).clamp_min(tiny)
    out = a + ab * (vb / den)[..., None] + ac * (vc / den)[..., None]

    def put(cond, q):
        return torch.where(cond[..., None], q, out)
    t_bc = ((d4 - d3) / ((d4 - d3) + (d5 - d6)).clamp_min(tiny)).clamp(0, 1)
    out = put((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
              b + (c - b) * t_bc[..., None])
    t_ac = (d2 / (d2 - d6).clamp_min(tiny)).clamp(0, 1)
    out = put((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * t_ac[..., None])
    t_ab = (d1 / (d1 - d3).clamp_min(tiny)).clamp(0, 1)
    out = put((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * t_ab[..., None])
    out = put((d6 >= 0) & (d5 <= d6), c.expand_as(out))
    out = put((d3 >= 0) & (d4 <= d3), b.expand_as(out))
    out = put((d1 <= 0) & (d2 <= 0), a.expand_as(out))
    return out


class DenseMPM:
    """The configuration's scene from ``x0 [N, 3]`` on one dense grid of
    ``G^3`` nodes over [0, (G - 1) dx]^3."""

    POLAR_ITERS = 12

    PAIRS = 1 << 22          # particle-triangle pairs a block of rows

    def __init__(self, cfg: dict, x0: torch.Tensor, v0, tri, dt: float,
                 dtype: torch.dtype, *, solve_rtol: float = 1e-10,
                 solve_iters: int = 500):
        dev = x0.device
        self.cfg, self.dtype, self.dev = cfg, dtype, dev
        f = dict(dtype=dtype, device=dev)
        self.dx = float(cfg["dx"])
        self.dt = float(dt)
        mat = cfg["material"]
        if mat["model"] != "FixedCorotated":
            raise ValueError(f"no reference for {mat['model']}")
        E, nu = mat["E"], mat["nu"]
        self.mu = E / (2.0 * (1.0 + nu))
        self.lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        vol = self.dx ** 3 / mat["ppc"]
        n = x0.shape[0]
        self.x = x0.to(dtype)
        self.v = torch.zeros((n, 3), **f) if v0 is None else v0.to(dtype)
        self.F = torch.eye(3, **f).expand(n, 3, 3).clone()
        self.C = torch.zeros((n, 3, 3), **f)
        self.m = torch.full((n,), mat["rho"] * vol, **f)
        self.vol = torch.full((n,), vol, **f)
        self.g = torch.tensor(cfg["gravity"], **f)
        self.G = int(math.ceil(1.0 / self.dx)) + 3
        self.integrator = cfg["integrator"]
        self.tri = None
        if tri is not None:
            ob = cfg["obstacle"]
            self.tri = tri.to(dtype)
            self.dhat, self.kappa = ob["dhat"], ob["kappa"]
        self.solve_rtol, self.solve_iters = solve_rtol, solve_iters
        self.cg_counts = []
        G = self.G
        gi = torch.arange(G, device=dev)
        node = torch.stack(torch.meshgrid(gi, gi, gi, indexing="ij"),
                           -1).reshape(-1, 3)
        # the colliders' node set is geometry of the configuration: found in
        # float64 whatever the precision of the state
        self.sticky = self._sticky_nodes(node.to(torch.float64) * self.dx)

    # -- grid ---------------------------------------------------------------
    def _sticky_nodes(self, nx):
        """Nodes inside a sticky collider (sdf < 0): v = 0 there."""
        inside = torch.zeros(nx.shape[0], dtype=torch.bool, device=self.dev)
        for col in self.cfg["colliders"]:
            if col["kind"] != "sticky":
                raise ValueError("the reference takes sticky colliders")
            if col["levelset"] == "half_space":
                o = torch.tensor(col["origin"], dtype=nx.dtype,
                                 device=self.dev)
                nrm = torch.tensor(col["normal"], dtype=nx.dtype,
                                   device=self.dev)
                inside |= ((nx - o) * nrm).sum(-1) < 0
            elif col["levelset"] == "box_walls":
                lo, hi = col["lo"], col["hi"]
                c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
                q = (nx - c).abs() - h
                box_sdf = q.clamp_min(0).norm(dim=-1) + \
                    q.amax(-1).clamp_max(0)
                inside |= -box_sdf < 0
            else:
                raise ValueError(f"no reference for {col['levelset']}")
        return inside

    def _stencil(self):
        """(flat node index [N, 27], w [N, 27], xdiff [N, 27, 3])."""
        xi = torch.nan_to_num(self.x / self.dx)
        base = torch.floor(xi - 0.5)
        fx = xi - base
        w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                         0.5 * (fx - 0.5) ** 2], -1)         # [N, 3, 3]
        G = self.G
        # a particle outside the unit cube, or not finite (only a run that
        # has diverged, such as the control's, gets there) is read at the
        # grid's edge
        base = base.clamp(0, G - 3)
        offs = torch.tensor(_OFFS, device=self.dev)
        node = base.long()[:, None, :] + offs[None]            # [N, 27, 3]
        wn = (w[:, 0, offs[:, 0]] * w[:, 1, offs[:, 1]] *
              w[:, 2, offs[:, 2]])
        xdiff = (node.to(self.dtype) - xi[:, None, :]) * self.dx
        flat = (node[..., 0] * G + node[..., 1]) * G + node[..., 2]
        return flat, wn, xdiff

    def _p2g(self, flat, payload):
        C = payload.shape[-1]
        acc = torch.zeros((self.G ** 3, C), dtype=self.dtype,
                          device=self.dev)
        acc.index_add_(0, flat.reshape(-1), payload.reshape(-1, C))
        return acc

    def _kirchhoff(self, F):
        R = _polar(F, self.POLAR_ITERS)
        cof = _cof(F)
        J = (F[..., :, 0] * cof[..., :, 0]).sum(-1)
        P = 2.0 * self.mu * (F - R) + \
            (self.lam * (J - 1.0))[..., None, None] * cof
        return _mm(P, F.transpose(-1, -2))

    # -- steps --------------------------------------------------------------
    def step(self):
        if self.integrator["kind"] == "explicit":
            self._explicit()
        else:
            self._implicit()

    def _advance(self, flat, wn, xdiff, gv):
        dinv = 4.0 / (self.dx * self.dx)
        wv = wn[..., None] * gv[flat]                            # [N, 27, 3]
        v_new = wv.sum(1)
        C_new = dinv * (wv[..., :, None] * xdiff[..., None, :]).sum(1)
        eye = torch.eye(3, dtype=self.dtype, device=self.dev)
        self.F = _mm(eye + self.dt * C_new, self.F)
        self.x = self.x + self.dt * v_new
        self.v, self.C = v_new, C_new

    def _explicit(self):
        dt, dinv = self.dt, 4.0 / (self.dx * self.dx)
        flat, wn, xdiff = self._stencil()
        tau = self._kirchhoff(self.F)
        A = self.m[:, None, None] * self.C - \
            (dt * dinv * self.vol)[:, None, None] * tau
        Ax = (A[:, None, :, :] * xdiff[:, :, None, :]).sum(-1)   # [N, 27, 3]
        mom = wn[..., None] * (self.m[:, None, None] * self.v[:, None, :] +
                               Ax)
        acc = self._p2g(flat, torch.cat([(wn * self.m[:, None])[..., None],
                                         mom], -1))
        gm, gmv = acc[:, 0], acc[:, 1:]
        has = gm > 0
        gv = torch.where(has[:, None],
                         gmv / torch.where(has, gm, 1.0)[:, None],
                         0.0) + dt * self.g
        gv = torch.where((has & ~self.sticky)[:, None], gv, 0.0)
        self._advance(flat, wn, xdiff, gv)

    def _contact(self):
        """Barrier force [N, 3] and Gauss-Newton Hessian [N, 3, 3]."""
        dh2, kap = self.dhat * self.dhat, self.kappa
        fc = torch.zeros_like(self.x)
        Hc = torch.zeros((self.x.shape[0], 3, 3), dtype=self.dtype,
                         device=self.dev)
        tri = self.tri
        pad = 2.0 * self.dhat
        lo = tri.double().amin((0, 1)) - pad
        hi = tri.double().amax((0, 1)) + pad
        xd = self.x.double()
        rows = torch.nonzero(((xd > lo) & (xd < hi)).all(-1))[:, 0]
        a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
        step = max(1, self.PAIRS // tri.shape[0])
        for s in range(0, rows.shape[0], step):
            r = rows[s:s + step]
            p = self.x[r][:, None, :]
            diff = p - _closest_on_triangle(p, a, b, c)         # [R, M, 3]
            d2 = (diff * diff).sum(-1)
            act = (d2 < dh2) & (d2 > 0)
            s2 = torch.where(act, d2, dh2)
            lg = torch.log(s2 / dh2)
            bg = -kap * (2.0 * (s2 - dh2) * lg + (s2 - dh2) ** 2 / s2)
            bh = -kap * (2.0 * lg + 2.0 * (s2 - dh2) / s2 +
                         (s2 - dh2) * (s2 + dh2) / (s2 * s2))
            bg = torch.where(act, bg, 0.0)
            bh = torch.where(act, bh.clamp_min(0.0), 0.0)
            fc[r] = -((2.0 * bg)[..., None] * diff).sum(1)
            Hc[r] = ((4.0 * bh)[..., None, None] *
                     (diff[..., :, None] * diff[..., None, :])).sum(1)
        return fc, Hc

    def _dP(self, F, R, S_inv_op, cof, J, dF):
        """dP(F)[dF] of FixedCorotated."""
        M = _mm(R.transpose(-1, -2), dF)
        w = (S_inv_op * _skew_axial(M - M.transpose(-1, -2))[..., None, :]
             ).sum(-1)
        dR = _mm(R, _cross_matrix(w))
        dJ = (cof * dF).sum((-1, -2))
        dcof = 0.5 * (_cof(F + dF) - _cof(F - dF))
        return 2.0 * self.mu * (dF - dR) + \
            (self.lam * dJ)[..., None, None] * cof + \
            (self.lam * (J - 1.0))[..., None, None] * dcof

    def _implicit(self):
        dt, dinv = self.dt, 4.0 / (self.dx * self.dx)
        flat, wn, xdiff = self._stencil()
        if self.tri is not None:
            fc, Hc = self._contact()
        else:
            fc, Hc = torch.zeros_like(self.x), None
        F = self.F
        tau = self._kirchhoff(F)
        A_m = self.m[:, None, None] * self.C
        A_f = -(dinv * self.vol)[:, None, None] * tau
        Am = (A_m[:, None, :, :] * xdiff[:, :, None, :]).sum(-1)
        Af = (A_f[:, None, :, :] * xdiff[:, :, None, :]).sum(-1)
        payload = torch.cat([
            (wn * self.m[:, None])[..., None],
            wn[..., None] * (self.m[:, None, None] * self.v[:, None, :] + Am),
            wn[..., None] * (fc[:, None, :] + Af)], -1)
        acc = self._p2g(flat, payload)
        gm, gmv, fint = acc[:, 0], acc[:, 1:4], acc[:, 4:7]
        has = gm > 0
        minv = torch.where(has, 1.0 / torch.where(has, gm, 1.0), 0.0)
        v_pred = (gmv + dt * fint) * minv[:, None] + dt * self.g
        v_pred = torch.where(has[:, None], v_pred, 0.0)
        v_bc = torch.where(self.sticky[:, None], 0.0, v_pred)
        constrained = ((v_bc - v_pred).abs() > 0).any(-1)
        free = (has & ~constrained)[:, None].to(self.dtype)

        R = _polar(F, self.POLAR_ITERS)
        S = _mm(R.transpose(-1, -2), F)
        S = 0.5 * (S + S.transpose(-1, -2))
        tr = S.diagonal(dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=self.dtype, device=self.dev)
        S_inv_op = torch.linalg.inv(tr[:, None, None] * eye - S) \
            if self.dtype != torch.bfloat16 else \
            torch.linalg.inv((tr[:, None, None] * eye - S).float()).to(
                self.dtype)
        cof = _cof(F)
        J = (F[..., :, 0] * cof[..., :, 0]).sum(-1)
        Ft = F.transpose(-1, -2)
        kscale = (dt * dinv * self.vol)[:, None, None]

        def A_op(u):
            wu = wn[..., None] * u[flat]                          # [N, 27, 3]
            s0 = wu.sum(1)
            dC = dinv * (wu[..., :, None] * xdiff[..., None, :]).sum(1)
            dP = self._dP(F, R, S_inv_op, cof, J, dt * _mm(dC, F))
            Ak = kscale * _mm(dP, Ft)
            q = (Ak[:, None, :, :] * xdiff[:, :, None, :]).sum(-1)
            if Hc is not None:
                q = q + ((dt * dt) * (Hc * s0[:, None, :]).sum(-1))[:, None]
            return gm[:, None] * u + self._p2g(flat, wn[..., None] * q)

        b = free * (gm[:, None] * v_pred)
        x = free * v_pred
        r = free * (b - A_op(x))
        z = r * minv[:, None]
        p = z
        rz = (r * z).sum()
        bnorm = (b * b).sum().sqrt()
        it = 0
        while it < self.solve_iters and \
                float((r * r).sum().sqrt()) > self.solve_rtol * float(bnorm):
            Ap = free * A_op(p)
            pAp = (p * Ap).sum()
            alpha = rz / torch.where(pAp == 0, 1.0, pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            z = r * minv[:, None]
            rz_new = (r * z).sum()
            p = z + (rz_new / torch.where(rz == 0, 1.0, rz)) * p
            rz = rz_new
            it += 1
        self.cg_counts.append(it)
        gv = torch.where(free > 0, x, v_bc)
        gv = torch.where(has[:, None], gv, 0.0)
        self._advance(flat, wn, xdiff, gv)


def run(cfg: dict, x0: torch.Tensor, v0, tri, dt: float, steps: int,
        dtype: torch.dtype):
    """(x, v, F) of the particles after ``steps`` steps from positions
    ``x0`` and velocities ``v0`` (None: at rest), against the obstacle's
    triangles ``tri [M, 3, 3]`` (None: no contact)."""
    sim = DenseMPM(cfg, x0, v0, tri, dt, dtype)
    for _ in range(steps):
        sim.step()
    return sim.x, sim.v, sim.F
