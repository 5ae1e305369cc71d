"""The port's mesh contact (zpc_tpu_torch.geometry.contact,
zpc_tpu_torch.sim.contact_implicit and the contact hooks of
sim/implicit_binned2.py) against zpc_tpu on the same seeded numpy inputs.

Scenes are tests/test_contact_implicit.py's: 256-512 particles in a slab
above a two-triangle floor at dx 0.05, 64-96 bins.  Tolerances:

* derivatives (the barrier trio, the distance gradients, the mollifier and
  its gradient, tangent bases, friction) within 1e-5 of the largest entry
  of the reference output, Hessians within 1e-4 of theirs;
* broad-phase hits equal as sets per bin, the overflow flag equal;
* barrier force fc and Hessian Hc within 1e-5 of their largest entries
  (the port sums the candidate slots in another order);
* fc against -dE/dx of the port's own energy by torch.autograd within
  rtol 1e-4, atol 1e-8 (the JAX test's oracle);
* times of impact within 1e-5;
* steps and rollouts with the change-based tolerances of
  tests/test_torch_implicit.py: x within 1e-6, v 5e-4, F 1e-5, and what a
  step changes within 1e-4 of the largest change plus 4 fp32 ulps; CG
  iteration counts equal.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.geometry import contact as TC
from zpc_tpu_torch.sim import implicit_binned2 as ti2
from zpc_tpu_torch.sim import mpm_binned2 as tb2
from zpc_tpu_torch.sim.contact_implicit import MeshContact
from zpc_tpu_torch.models.constitutive import FixedCorotated
from zpc_tpu_torch.sim.mpm import MPMSim, make_mpm_state

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.geometry import contact as JC
    from zpc_tpu.models.constitutive import FixedCorotated as JFixed
    from zpc_tpu.sim import implicit_binned2 as ji2
    from zpc_tpu.sim import mpm as jmpm
    from zpc_tpu.sim import mpm_binned2 as jb2
    from zpc_tpu.sim.contact_implicit import ContactSet as JSet
    from zpc_tpu.sim.contact_implicit import MeshContact as JMesh
except ImportError:
    pass

CPU = torch.device("cpu")
TOL = dict(x=1e-6, v=5e-4, F=1e-5)
CHANGE_TOL = 1e-4
DERIV_REL, HESS_REL, FORCE_REL, TOI_TOL = 1e-5, 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# geometry/contact.py
# ---------------------------------------------------------------------------

def _pt_inputs(kind):
    """[n, 12] point-triangle stacks: random (tests/test_geometry_robust.py's
    setup) or points on the unit triangle's region boundaries."""
    if kind == "random":
        rng = np.random.default_rng(0)
        n = 32
        t0 = rng.uniform(-1, 1, (n, 3))
        t1 = t0 + rng.uniform(0.5, 1.0, (n, 3))
        t2 = t0 + rng.uniform(-1.0, -0.5, (n, 3))
        p = rng.uniform(-2, 2, (n, 3))
        return np.concatenate([p, t0, t1, t2], -1).astype(np.float32)
    # the unit triangle, and points on its vertex / edge / face region
    # boundaries (d1 = 0, d3 = 0, d1 = d2 = 0, the face-edge planes), on
    # its vertices and edges and inside it
    tri = np.asarray([0, 0, 0, 1, 0, 0, 0, 1, 0], np.float32)
    p = np.asarray([[0, -1, 0.3], [1, -1, 0.2], [0, 0, 1], [0.5, 0.5, 1],
                    [0.5, 0, 0.7], [-1, -1, 0], [0.5, -1, 0], [1, 1, 0],
                    [0.2, 0.3, 0.5], [0.2, 0.3, 0], [1, 0, 0], [0.5, 0, 0],
                    [0.5, 0.5, 0], [1, 0, -1]], np.float32)
    return np.concatenate([p, np.broadcast_to(tri, (len(p), 9))],
                          -1).astype(np.float32)


def _ee_inputs(kind):
    if kind == "random":
        rng = np.random.default_rng(1)
        n = 32
        p0 = rng.uniform(-1, 1, (n, 3))
        p1 = p0 + rng.uniform(0.5, 1.5, (n, 3))
        q0 = rng.uniform(-1, 1, (n, 3)) + np.asarray([0, 0, 2.0])
        q1 = q0 + rng.uniform(-1.5, -0.5, (n, 3))
        return np.concatenate([p0, p1, q0, q1], -1).astype(np.float32)
    # crossing, skew and touching pairs (the parallel pair's derivative is
    # that of a clamp on rounding noise and is compared by value only)
    return np.asarray([[-1, 0, 1, 1, 0, 1, 0, -1, 0, 0, 1, 0],
                       [0, 0, 0, 1, 0, 0, 1, 0.5, 1, 1, 2, 1],
                       [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0]], np.float32)


def _split(x12, lib):
    return [lib(np.ascontiguousarray(x12[..., 3 * i:3 * i + 3]))
            for i in range(4)]


@pytest.mark.parametrize("kind", ["random", "boundary"])
@pytest.mark.parametrize("fn", ["pt_dist2_grad", "pt_dist2_hess"])
def test_pt_derivatives_match_jax(fn, kind):
    x = _pt_inputs(kind)
    want = getattr(JC, fn)(*_split(x, jnp.asarray))
    got = getattr(TC, fn)(*_split(x, torch.from_numpy))
    _close(got, want, HESS_REL if fn.endswith("hess") else DERIV_REL, fn)


@pytest.mark.parametrize("kind", ["random", "special"])
@pytest.mark.parametrize("fn", ["ee_dist2_grad", "ee_dist2_hess"])
def test_ee_derivatives_match_jax(fn, kind):
    x = _ee_inputs(kind)
    want = getattr(JC, fn)(*_split(x, jnp.asarray))
    got = getattr(TC, fn)(*_split(x, torch.from_numpy))
    _close(got, want, HESS_REL if fn.endswith("hess") else DERIV_REL, fn)


def test_pt_hessian_is_symmetric():
    H = TC.pt_dist2_hess(*_split(_pt_inputs("random"), torch.from_numpy))
    torch.testing.assert_close(H, H.transpose(-1, -2), rtol=0, atol=1e-4)


def test_spd_project_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 12, 12)).astype(np.float32)
    for H in (A + A.transpose(0, 2, 1), np.einsum("bij,bkj->bik", A, A)):
        want = JC.spd_project(jnp.asarray(H))
        got = TC.spd_project(torch.from_numpy(H))
        _close(got, want, HESS_REL, "spd_project")
        assert (np.linalg.eigvalsh(got.numpy()) >= -1e-4).all()


@pytest.mark.parametrize("fn", ["barrier", "barrier_grad", "barrier_hess"])
def test_barrier_matches_jax(fn):
    dhat2 = 0.01
    # outside, at and inside dhat, down to 1e-8 of it, at and below 0
    d2 = np.concatenate([np.geomspace(1e-10, 1e-2, 64), [0.0, -1e-3, 0.01,
                         0.011, 0.02]]).astype(np.float32)
    for kappa in (1.0, 10.0, 2e4):
        want = getattr(JC, fn)(jnp.asarray(d2), dhat2, kappa)
        got = getattr(TC, fn)(torch.from_numpy(d2), dhat2, kappa)
        _close(got, want, DERIV_REL, f"{fn} kappa {kappa}")
    # tests/test_geometry_robust.py's invariants on the port alone
    if fn == "barrier":
        assert float(TC.barrier(0.02, dhat2)) == 0.0
        assert float(TC.barrier(0.005, dhat2)) > 0.0
    if fn == "barrier_grad":
        fd = (float(TC.barrier(0.004 + 1e-6, dhat2)) -
              float(TC.barrier(0.004 - 1e-6, dhat2))) / 2e-6
        assert abs(float(TC.barrier_grad(0.004, dhat2)) - fd) < 2e-2 * abs(fd)


def test_barrier_gradient_has_no_nan_outside():
    """autograd through the safe-value pattern: beyond dhat and at 0 the
    gradient is 0, not NaN."""
    d2 = torch.tensor([0.0, 0.005, 0.01, 0.02], requires_grad=True)
    TC.barrier(d2, 0.01).sum().backward()
    assert torch.isfinite(d2.grad).all()
    assert d2.grad[0] == 0 and d2.grad[2] == 0 and d2.grad[3] == 0


def _mollifier_inputs():
    rng = np.random.default_rng(3)
    n = 32
    p0, p1, q0 = rng.standard_normal((3, n, 3)).astype(np.float32)
    q1 = q0 + (p1 - p0) * np.float32(1.0) + (1e-2 * rng.standard_normal(
        (n, 3))).astype(np.float32) * (np.arange(n)[:, None] % 2)
    return p0, p1, q0, q1.astype(np.float32), p1 - p0, q1 - q0


@pytest.mark.parametrize("fn", ["edge_edge_mollifier",
                                "edge_edge_mollifier_grad"])
def test_mollifier_matches_jax(fn):
    args = [np.ascontiguousarray(a, np.float32) for a in _mollifier_inputs()]
    want = getattr(JC, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(TC, fn)(*[torch.from_numpy(a) for a in args])
    assert np.asarray(want).std() > 0, "no lane inside the mollifier"
    _close(got, want, DERIV_REL, fn)


def test_tangent_bases_and_displacements_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 16, 3)).astype(np.float32)
    bary = rng.dirichlet(np.ones(3), 16).astype(np.float32)
    s, t = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    j = [jnp.asarray(a) for a in x]
    tt = [torch.from_numpy(a) for a in x]
    for fn in ("pt_tangent_basis", "ee_tangent_basis"):
        for w, g in zip(getattr(JC, fn)(*j[:4]), getattr(TC, fn)(*tt[:4])):
            _close(g, w, DERIV_REL, fn)
    # the orthonormality invariant of tests/test_geometry_robust.py
    b0, b1 = TC.pt_tangent_basis(*tt[:4])
    n = torch.linalg.cross(tt[2] - tt[1], tt[3] - tt[1])
    assert float((b0 * b1).sum(-1).abs().max()) < 1e-6
    assert float((b0.norm(dim=-1) - 1).abs().max()) < 1e-5
    assert float((b0 * n).sum(-1).abs().max()) < 1e-5
    _close(TC.relative_displacement_pt(*tt[4:8], torch.from_numpy(bary)),
           JC.relative_displacement_pt(*j[4:8], jnp.asarray(bary)),
           DERIV_REL, "relative_displacement_pt")
    _close(TC.relative_displacement_ee(*tt[4:8], torch.from_numpy(s),
                                       torch.from_numpy(t)),
           JC.relative_displacement_ee(*j[4:8], jnp.asarray(s),
                                       jnp.asarray(t)),
           DERIV_REL, "relative_displacement_ee")


@pytest.mark.parametrize("fn", ["friction_f0", "friction_f1_over_x"])
def test_friction_matches_jax(fn):
    epsvh = 1e-3
    y = np.concatenate([np.geomspace(1e-7, 1e-1, 64),
                        [epsvh * (1 - 1e-6), epsvh, epsvh * (1 + 1e-6)]]
                       ).astype(np.float32)
    _close(getattr(TC, fn)(torch.from_numpy(y), epsvh),
           getattr(JC, fn)(jnp.asarray(y), epsvh), DERIV_REL, fn)
    if fn == "friction_f1_over_x":
        lo = float(TC.friction_f1_over_x(epsvh * (1 - 1e-6), epsvh))
        hi = float(TC.friction_f1_over_x(epsvh * (1 + 1e-6), epsvh))
        assert abs(lo - hi) / hi < 1e-3
    else:
        assert abs(float(TC.friction_f0(epsvh, epsvh)) - epsvh) < 1e-9


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _floor_np(y=0.2, lo=-1.0, hi=2.0):
    """tests/test_contact_implicit.py's _floor_mesh."""
    a, b, c, d = [lo, y, lo], [hi, y, lo], [hi, y, hi], [lo, y, hi]
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


def test_contact_scenes():
    from benchmarks import run_all
    for res in (4, 32):
        np.testing.assert_array_equal(scenes.terrain_mesh(res, CPU).numpy(),
                                      np.asarray(run_all._terrain_mesh(res)))
    assert scenes.terrain_mesh(224, CPU).shape == (100_352, 3, 3)
    np.testing.assert_array_equal(
        scenes.floor_mesh(0.57, 0.0, 1.0, CPU).numpy(),
        _floor_np(0.57, 0.0, 1.0))
    sim, st, dt, cfg, mc = scenes.contact_block(
        4096, scenes.floor_mesh(0.57, 0.0, 1.0, CPU), CPU)
    assert dt == 5e-4 and cfg == scenes.implicit_config(4096)
    assert (mc.dhat, mc.kappa, mc.max_tris, mc.tile, mc.use_ccd) == (
        0.01, 10.0, 8, 128, False)
    assert mc.tri.shape == (2, 3, 3) and int(mc.bvh.count) == 2


def test_build_matches_jax():
    tri = scenes.terrain_mesh(8, CPU).numpy()
    want = JMesh.build(jnp.asarray(tri), dhat=0.01, kappa=10.0)
    got = MeshContact.build(torch.from_numpy(tri), 0.01, 10.0)
    a, b = interop.lbvh_to_numpy(want.bvh), interop.lbvh_to_numpy(got.bvh)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ---------------------------------------------------------------------------
# the broad and narrow phase on a binned state
# ---------------------------------------------------------------------------

def _jsetup(n=512, ylo=0.3, yhi=0.5, seed=42):
    """tests/test_contact_implicit.py's _setup: n particles in [0.3, 0.7] x
    [ylo, yhi] x [0.3, 0.7], dx 0.05, FixedCorotated (E 1e4, nu 0.3)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.3, 0.7, n), rng.uniform(ylo, yhi, n),
                  rng.uniform(0.3, 0.7, n)], -1)
    st = jmpm.make_mpm_state(jnp.asarray(x, jnp.float32), dx=0.05,
                             block_capacity=512)
    sim = jmpm.MPMSim(model=JFixed.from_young_poisson(1e4, 0.3),
                      gravity=jnp.asarray([0.0, -9.8, 0.0]))
    return sim, st


def _binned(sim, st, bins):
    """The JAX bin state and context, and the port's from the same bins."""
    cfg = jb2.BinnedConfig2(bins_capacity=bins)
    bst = jb2.bin_state(sim, st, cfg)
    jctx = jb2._make_ctx3(bst, cfg)
    jalive = (bst.pid >= 0).reshape(bins, jb2.K)
    tbst = interop.binstate_from_jax(bst, CPU)
    tctx = tb2._make_ctx(tbst, interop.config_from_jax(cfg))
    return dict(bst=bst, jctx=jctx, jalive=jalive, tctx=tctx,
                talive=tctx.alive.view(bins, tb2.K),
                xb=bst.cols.reshape(bins, jb2.K, -1)[..., 0:3])


# (mesh, dhat, max_tris, overflow expected): tests/test_contact_implicit.py's
# near and far floors, and a small heightfield through the slab whose
# windows hold more candidates than max_tris = 2
MESHES = {
    "near_floor": (lambda: _floor_np(0.3), 0.02, 8, False),
    "far_floor": (lambda: _floor_np(-5.0), 0.02, 8, False),
    "terrain": (lambda: scenes.terrain_mesh(8, CPU, y0=0.35,
                                            amp=0.05).numpy(), 0.02, 2, True),
}


@pytest.fixture(scope="module")
def binned_scene():
    sim, st = _jsetup()
    return _binned(sim, st, 64)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_broad_phase_matches_jax(mesh, binned_scene):
    make, dhat, max_tris, flagged = MESHES[mesh]
    s = binned_scene
    jm = JMesh.build(jnp.asarray(make()), dhat=dhat, kappa=1.0,
                     max_tris=max_tris)
    tm = MeshContact.build(torch.from_numpy(make()), dhat, 1.0,
                           max_tris=max_tris)
    jc = jm.broad_phase(s["jctx"], s["jalive"])
    tc = tm.broad_phase(s["tctx"], s["talive"])
    jh, th = np.asarray(jc.hits), tc.hits.numpy()
    assert th.shape == jh.shape
    for b in range(jh.shape[0]):
        assert set(th[b][th[b] >= 0]) == set(jh[b][jh[b] >= 0]), b
    assert bool(tc.overflow) == bool(jc.overflow) == flagged
    if mesh == "far_floor":
        assert (th < 0).all()
    else:
        assert (th >= 0).sum() > 0

    # the narrow phase on JAX's candidate set
    cset = interop.contact_set_from_jax(jc, CPU)
    fc, Hc = jm.forces_and_hessians(jc, s["xb"], s["jalive"])
    tfc, tHc = tm.forces_and_hessians(cset, torch.from_numpy(
        np.array(s["xb"])), s["talive"])
    if mesh != "far_floor":
        assert np.abs(np.asarray(fc)).max() > 0, "no lane in contact"
    _close(tfc, fc, FORCE_REL, "fc")
    _close(tHc, Hc, FORCE_REL, "Hc")
    e = jm.energy(jc, s["xb"], s["jalive"])
    te = tm.energy(cset, torch.from_numpy(np.array(s["xb"])), s["talive"])
    _close(te, e, FORCE_REL, "energy")


def test_force_is_minus_energy_gradient():
    """tests/test_contact_implicit.py's oracle on the port: fc = -dE/dx
    (autograd), the GN Hessian symmetric with a non-negative trace."""
    sim, st = _jsetup(n=256, ylo=0.21, yhi=0.25)
    s = _binned(sim, st, 64)
    mc = MeshContact.build(torch.from_numpy(_floor_np(0.2)), 0.05, 1e-3)
    cset = mc.broad_phase(s["tctx"], s["talive"])
    xb = torch.from_numpy(np.array(s["xb"]))
    fc, Hc = mc.forces_and_hessians(cset, xb, s["talive"])
    x = xb.clone().requires_grad_(True)
    g, = torch.autograd.grad(mc.energy(cset, x, s["talive"]), x)
    assert float(fc.abs().max()) > 0
    np.testing.assert_allclose(fc.numpy(), -g.numpy(), rtol=1e-4, atol=1e-8)
    H = Hc.numpy()
    np.testing.assert_allclose(H, np.swapaxes(H, -1, -2), atol=1e-6)
    assert (np.einsum("...ii->...", H) >= -1e-7).all()


def test_toi_matches_jax():
    """tests/test_contact_implicit.py's synthetic set: one bin whose lanes
    head straight through the floor."""
    K = tb2.K
    jm = JMesh.build(jnp.asarray(_floor_np(0.0)), dhat=0.01, kappa=1.0)
    xb = np.tile(np.asarray([0.5, 0.05, 0.5], np.float32), (1, K, 1))
    dxb = np.tile(np.asarray([0.0, -0.2, 0.0], np.float32), (1, K, 1))
    # vary the lanes: heights, slants, a few that miss the floor's reach
    rng = np.random.default_rng(5)
    xb[0, :, 1] += rng.uniform(0, 0.1, K).astype(np.float32)
    dxb[0, :, 0] += rng.uniform(-0.1, 0.1, K).astype(np.float32)
    dxb[0, ::7, 1] *= -1
    alive = np.ones((1, K), bool)
    alive[0, -3:] = False
    jset = JSet(hits=jnp.asarray([[0, 1]], jnp.int32),
                overflow=jnp.bool_(False))
    want = np.asarray(jm.toi(jset, jnp.asarray(xb), jnp.asarray(dxb),
                             jnp.asarray(alive)))
    tm = interop.mesh_contact_from_jax(jm, CPU)
    got = tm.toi(interop.contact_set_from_jax(jset, CPU),
                 torch.from_numpy(xb), torch.from_numpy(dxb),
                 torch.from_numpy(alive)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOI_TOL)
    hit = alive[0] & (dxb[0, :, 1] < 0)
    assert (got[0, hit] < 1).all() and (got[0, hit] > 0).all()
    assert (got[0, ~hit] == 1).all()
    # the end points stay above the floor
    assert (xb[0, :, 1] + got[0] * dxb[0, :, 1] > 0)[alive[0]].all()


# ---------------------------------------------------------------------------
# the contact-coupled implicit step
# ---------------------------------------------------------------------------

def _assert_close(k, got, want, init):
    """tests/test_torch_implicit.py's check: ``got`` within TOL[k] of
    ``want``, its change from ``init`` within CHANGE_TOL of the largest
    change plus 4 fp32 ulps of the values."""
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[k], err_msg=k)
    change = want - init
    tol = CHANGE_TOL * np.abs(change).max() + \
        4 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got - init, change, rtol=0, atol=tol,
                               err_msg=f"{k} - {k}0")


def _assert_cols(got, want, init):
    for k, sl in (("x", slice(0, 3)), ("v", slice(3, 6)),
                  ("F", slice(6, 15))):
        _assert_close(k, got[:, sl], want[:, sl], init[:, sl])


def _assert_states(got, want, init):
    a, b = interop.state_to_numpy(want), interop.state_to_numpy(got)
    z = interop.state_to_numpy(init)
    for k in ("x", "v", "F"):
        _assert_close(k, b[k], a[k], z[k])


def _counting(module, monkeypatch):
    """Record the iteration count of every ``cg`` solve that ``module``
    runs (JAX's as traced values of the same program)."""
    counts, solve = [], module.cg

    def cg(*args, **kw):
        res = solve(*args, **kw)
        counts.append(res.iters)
        return res
    monkeypatch.setattr(module, "cg", cg)
    return counts


def test_contact_step_matches_jax(monkeypatch):
    """test_single_step_forces_point_up's scene through the MPMState form,
    with and without contact: the port's step equals JAX's, with the same
    CG count, and the barrier slows the fall."""
    sim, st = _jsetup(n=256, ylo=0.205, yhi=0.23)
    cfg = jb2.BinnedConfig2(bins_capacity=64)
    mc = JMesh.build(jnp.asarray(_floor_np(0.2)), dhat=0.03, kappa=2e-2,
                     max_tris=4)
    jcounts = _counting(ji2, monkeypatch)
    tcounts = _counting(ti2, monkeypatch)

    def step(s, c):
        jcounts.clear()
        return jax.jit(lambda t: (ji2.implicit_step_binned2(
            sim, t, jnp.float32(1e-3), cfg, cg_iters=50, contact=c),
            list(jcounts)))(s)
    tsim = interop.sim_from_jax(sim, CPU)
    tcfg = interop.config_from_jax(cfg)
    tst = interop.state_from_jax(st, CPU)
    tmc = interop.mesh_contact_from_jax(mc, CPU)
    vy = {}
    for name, jc, tc in (("contact", mc, tmc), ("free", None, None)):
        (ref, jov), jit_counts = step(st, jc)
        tcounts.clear()
        out, ov = ti2.implicit_step_binned2(tsim, tst, 1e-3, tcfg,
                                            cg_iters=50, contact=tc)
        assert not bool(ov) and not bool(jov)
        assert [int(i) for i in jit_counts] == tcounts and min(tcounts) > 0
        _assert_states(out, ref, st)
        vy[name] = float(out.particles["v"][:, 1].mean())
    assert vy["contact"] > vy["free"]


def test_contact_precond_step_matches_jax():
    """test_contact_precond_variant_converges's scene: one step with the
    barrier-diagonal Jacobi preconditioner, from the same bins."""
    sim, st = _jsetup(n=512, ylo=0.21, yhi=0.3)
    cfg = jb2.BinnedConfig2(bins_capacity=96)
    mc = JMesh.build(jnp.asarray(_floor_np()), dhat=0.02, kappa=5e-2,
                     max_tris=4)
    bst = jb2.bin_state(sim, st, cfg)
    ref, it = jax.jit(lambda b: ji2.implicit_step_binned2(
        sim, b, jnp.float32(2e-3), cfg, cg_iters=40, contact=mc,
        rebin=False, with_stats=True, contact_precond=True))(bst)
    out, tit = ti2.implicit_step_binned2(
        interop.sim_from_jax(sim, CPU), interop.binstate_from_jax(bst, CPU),
        2e-3, interop.config_from_jax(cfg), cg_iters=40,
        contact=interop.mesh_contact_from_jax(mc, CPU), rebin=False,
        with_stats=True, contact_precond=True)
    assert tit == int(it) and 0 < tit <= 40
    assert not bool(out.overflow)
    assert bool(torch.isfinite(out.cols).all())
    _assert_cols(out.cols.numpy(), np.asarray(ref.cols), np.asarray(bst.cols))


def test_contact_precond_changes_the_preconditioner():
    """The barrier diagonal reaches the solve: at a stiff kappa the
    preconditioned step differs from the mass-only one."""
    sim, st = _jsetup(n=512, ylo=0.21, yhi=0.3)
    tsim = interop.sim_from_jax(sim, CPU)
    cfg = tb2.BinnedConfig2(bins_capacity=96)
    bst = tb2.bin_state(tsim, interop.state_from_jax(st, CPU), cfg)
    mc = MeshContact.build(torch.from_numpy(_floor_np()), 0.02, 2e4,
                           max_tris=4)
    outs = [ti2.implicit_step_binned2(tsim, bst, 2e-3, cfg, cg_iters=40,
                                      cg_tol=1e-6, contact=mc, rebin=False,
                                      with_stats=True, contact_precond=p)
            for p in (False, True)]
    assert not torch.equal(outs[0][0].cols, outs[1][0].cols)
    # both converge to the same system's solution
    torch.testing.assert_close(outs[0][0].cols, outs[1][0].cols, rtol=0,
                               atol=1e-4)


def _launched(st, vy, stretch):
    """``st`` with v = (0, vy, 0) and F = diag(stretch) on every particle."""
    p = st.particles
    vel = jnp.broadcast_to(jnp.asarray([0.0, vy, 0.0], jnp.float32),
                           p["v"].shape)
    F = jnp.broadcast_to(jnp.diag(jnp.asarray(stretch, jnp.float32)),
                         p["F"].shape)
    return type(st)(p.update(v=vel, F=F), st.grid, st.max_vel)


# (setup kwargs, initial v_y, F diagonal, dhat, kappa, use_ccd, CG
# iterations): test_no_penetration_vs_free_fall's scene, and a stretched
# block thrown onto a weak barrier, whose advection the CCD clamp shortens
# (stretched so that F changes by more than rounding: in a rigid fall its
# change is the noise of two summation orders)
ROLLOUTS = {
    "barrier": (dict(n=512, ylo=0.26, yhi=0.4), 0.0, [1.0, 1.0, 1.0], 0.03,
                2e-2, False, 40),
    "ccd": (dict(n=512, ylo=0.201, yhi=0.26), -3.0, [1.05, 0.95, 1.0], 0.02,
            1e-6, True, 30),
}


def _jax_chain_iters(sim, st, cfg, mc, steps, iters):
    """JAX's CG count of every step of its rollout, stepped one jitted step
    at a time (rebinning before a step when the last one asked)."""
    step = jax.jit(lambda b: ji2.implicit_step_binned2(
        sim, b, jnp.float32(2e-3), cfg, cg_iters=iters, contact=mc,
        rebin=False, with_stats=True))
    rebin = jax.jit(lambda b: jb2.rebin_adaptive(sim, b, cfg))
    b, out = jb2.bin_state(sim, st, cfg), []
    for _ in range(steps):
        if bool(b.needs_rebin):
            b = rebin(b)
        b, it = step(b)
        out.append(int(it))
    return out


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_contact_rollout_matches_jax(case, monkeypatch):
    kw, vy0, stretch, dhat, kappa, ccd, iters = ROLLOUTS[case]
    sim, st = _jsetup(**kw)
    st = _launched(st, vy0, stretch)
    cfg = jb2.BinnedConfig2(bins_capacity=96)
    floor_y, steps = 0.2, 12
    mc = JMesh.build(jnp.asarray(_floor_np(floor_y)), dhat=dhat, kappa=kappa,
                     max_tris=4, use_ccd=ccd)
    ref, jov = jax.jit(lambda s: ji2.implicit_rollout_binned2(
        sim, s, jnp.float32(2e-3), cfg, steps, cg_iters=iters,
        contact=mc))(st)
    jiters = _jax_chain_iters(sim, st, cfg, mc, steps, iters)
    titers = _counting(ti2, monkeypatch)
    tmc = interop.mesh_contact_from_jax(mc, CPU)
    alphas = []
    toi = tmc.toi

    def record(*a, **k):
        out = toi(*a, **k)
        alphas.append(float(out.min()))
        return out
    object.__setattr__(tmc, "toi", record)
    out, ov = ti2.implicit_rollout_binned2(
        interop.sim_from_jax(sim, CPU), interop.state_from_jax(st, CPU),
        2e-3, interop.config_from_jax(cfg), steps, cg_iters=iters,
        contact=tmc)
    assert not bool(ov) and not bool(jov)
    assert titers == jiters and min(titers) > 0
    _assert_states(out, ref, st)
    y = out.particles["x"][:, 1].numpy()
    assert np.isfinite(y).all() and y.min() > floor_y
    if ccd:
        assert len(alphas) == steps and min(alphas) < 0.5, alphas
    else:
        assert not alphas


def test_sustained_load_no_penetration_100_steps():
    """tests/test_contact_implicit.py's 100-step invariant on the port:
    under gravity onto the mesh, with the barrier and the CCD clamp, no
    particle crosses the mesh by more than dhat (checked every 10 steps)
    and the pile settles (mean v_y below 0.5)."""
    rng = np.random.default_rng(42)
    n = 512
    x = np.stack([rng.uniform(0.3, 0.7, n), rng.uniform(0.22, 0.42, n),
                  rng.uniform(0.3, 0.7, n)], -1).astype(np.float32)
    st = make_mpm_state(x, dx=0.05, device=CPU, block_capacity=512)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(1e4, 0.3,
                                                         device=CPU),
                 gravity=torch.tensor([0.0, -9.8, 0.0]))
    cfg = tb2.BinnedConfig2(bins_capacity=96)
    floor_y, dhat = 0.2, 0.02
    mc = MeshContact.build(scenes.floor_mesh(floor_y, -1.0, 2.0, CPU), dhat,
                           2e4, max_tris=4, use_ccd=True)
    cur, min_y = st, np.inf
    for _ in range(10):
        cur, ov = ti2.implicit_rollout_binned2(sim, cur, 2e-3, cfg, 10,
                                               cg_iters=30, contact=mc)
        assert not bool(ov)
        y = cur.particles["x"][:, 1]
        assert bool(torch.isfinite(y).all())
        min_y = min(min_y, float(y.min()))
    assert min_y > floor_y - dhat, min_y
    assert abs(float(cur.particles["v"][:, 1].mean())) < 0.5


@pytest.mark.cuda
def test_contact_on_cuda_matches_cpu():
    """The contact step on the card against the CPU on the sustained-load
    scene: broad-phase hits equal, 10 steps with CCD, CG counts within
    one, x, v, F within the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel has no CPU mode")
    dev = torch.device("cuda")

    def run(where):
        rng = np.random.default_rng(42)
        x = np.stack([rng.uniform(0.3, 0.7, 512), rng.uniform(0.21, 0.3, 512),
                      rng.uniform(0.3, 0.7, 512)], -1).astype(np.float32)
        st = make_mpm_state(x, dx=0.05, device=where, block_capacity=512)
        sim = MPMSim(model=FixedCorotated.from_young_poisson(
            1e4, 0.3, device=where), gravity=torch.tensor(
                [0.0, -9.8, 0.0], device=where))
        cfg = tb2.BinnedConfig2(bins_capacity=96)
        mc = MeshContact.build(scenes.floor_mesh(0.2, -1.0, 2.0, where),
                               0.02, 2e4, max_tris=4, use_ccd=True)
        bst = tb2.bin_state(sim, st, cfg)
        hits = mc.broad_phase(tb2._make_ctx(bst, cfg), (bst.pid >= 0).view(
            96, tb2.K)).hits.cpu()
        iters = []
        for _ in range(10):
            if bool(bst.needs_rebin):
                bst = tb2.rebin_adaptive(sim, bst, cfg)
            bst, it = ti2.implicit_step_binned2(
                sim, bst, 2e-3, cfg, cg_iters=30, contact=mc, rebin=False,
                with_stats=True)
            iters.append(it)
        return hits, tb2.unbin_state(bst, st), iters
    gh, g, gi = run(dev)
    ch, c, ci = run(CPU)
    assert torch.equal(gh.sort(1).values, ch.sort(1).values)
    assert all(abs(a - b) <= 1 for a, b in zip(gi, ci))
    for k in ("x", "v", "F"):
        err = (g.particles[k].cpu() - c.particles[k]).abs().max().item()
        assert err <= TOL[k], (k, err)
