"""The port's codimensional cloth (zpc_tpu_torch.sim.cloth) against
zpc_tpu on the same seeded numpy inputs, the state carried across by
``interop.cloth_from_jax``.

Scenes are tests/test_cloth.py's: single grids of 4 x 3 to 9 x 7 vertices
and its two-layer drops of 5 x 5 to 24 x 24 per layer.  Tolerances:

* topology (triangles, edges, hinges, incidence tables, stencil grids and
  triangle starts) equal bit for bit, rest lengths and angles equal;
* energies within rtol 1e-5 (test_cloth.py's window-against-dense
  tolerance), gradients within 1e-5 of their largest entry (the window
  barrier's within 1e-4: see WIN_GRAD_REL);
* candidate sets equal as sets per vertex, the overflow flags equal;
* assembled diagonal and applications, and the autodiff Hessian-vector
  product, within 1e-5 of their largest entry (test_cloth.py holds
  compacted against dense to rtol 1e-5);
* trajectories within test_cloth.py's rtol 3e-4, atol 5e-6 of JAX's,
  the overflow flags equal step for step.

JAX's steps compile slowly, so each mode's is jitted once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zpc_tpu_torch import interop, scenes
from zpc_tpu_torch.sim import cloth as TC

from _jax_jit import jit

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.sim import cloth as JC
except ImportError:
    pass

CPU = torch.device("cpu")
E_RTOL, REL = 1e-5, 1e-5
# the window barrier's gradient: XLA's compiled gradient and JAX's
# op-by-op one differ by 6.3e-5 of the largest entry on this state (the
# barrier's log amplifies the closest point's rounding); the port is within
# 4e-8 of the op-by-op one
WIN_GRAD_REL = 1e-4
TRAJ = dict(rtol=3e-4, atol=5e-6)
STEPS, DT = 5, np.float32(0.005)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rel=REL, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _sets(cand):
    return [set(int(v) for v in row if v >= 0) for row in _np(cand)]


def _two_layer(nx, spacing, gap, dhat, stencil=False):
    """tests/test_cloth.py's two-layer drop in zpc_tpu: layer A pinned at
    height 0.2, layer B free above it by ``gap``, half a cell over;
    ``stencil`` attaches the incidence tables and both grids' stencil."""
    simA, xA = JC.make_cloth_grid(nx, nx, spacing, height=0.2, dhat=dhat,
                                  ground_off=-10.0, k_stretch=2e2,
                                  k_bend=1e-4, mass=0.01)
    N = xA.shape[0]
    xB = xA + jnp.asarray([0.5 * spacing, gap, 0.5 * spacing])
    cat = lambda a, s=0: jnp.concatenate([a, a + s])
    sim = dataclasses.replace(
        simA, tris=cat(simA.tris, N), edges=cat(simA.edges, N),
        hinges=cat(simA.hinges, N), rest_len=cat(simA.rest_len),
        rest_angle=cat(simA.rest_angle), mass=cat(simA.mass),
        free=jnp.asarray(np.r_[np.zeros(N, bool), np.ones(N, bool)]),
        edge_inc=None, hinge_inc=None, stencil=None)
    if stencil:
        sim = JC.build_grid_stencil(JC.build_incidence(sim),
                                    ((0, nx, nx), (N, nx, nx)))
    return sim, jnp.concatenate([xA, xB])


def _pair(sim_j, x_j):
    return interop.cloth_from_jax(sim_j, CPU), torch.from_numpy(_np(x_j))


def _perturbed(x, scale, seed):
    rng = np.random.default_rng(seed)
    return (_np(x) + scale * rng.normal(size=x.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

_TOPO = ("tris", "edges", "hinges", "edge_inc", "hinge_inc")


def _same_topology(st, sj):
    for f in _TOPO:
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      _np(getattr(sj, f)), err_msg=f)
    for f in ("rest_len", "rest_angle", "mass", "free"):
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      _np(getattr(sj, f)), err_msg=f)
    assert st.stencil.grids == sj.stencil.grids
    assert st.stencil.tri_starts == sj.stencil.tri_starts
    for a, b in zip(st.stencil.rest_len + st.stencil.rest_angle,
                    sj.stencil.rest_len + sj.stencil.rest_angle):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("shape", [(4, 3), (9, 7), (3, 2)])
def test_make_cloth_grid(shape):
    pins = (0, shape[1] - 1)
    st, xt = TC.make_cloth_grid(*shape, 0.1, pinned=pins, device=CPU)
    sj, xj = JC.make_cloth_grid(*shape, 0.1, pinned=pins)
    np.testing.assert_array_equal(_np(xt), _np(xj))
    _same_topology(st, sj)
    _same_topology(interop.cloth_from_jax(sj, CPU), sj)


def test_two_layer_scene_and_stencil_guards():
    """scenes.cloth_two_layer is bench_cloth's scene (its gap and dhat are
    0.015 and 0.008 at nx = 64); build_grid_stencil and the stale-stencil
    check refuse what the JAX package refuses."""
    nx = 6
    st, xt = scenes.cloth_two_layer(nx, CPU)
    sj, xj = _two_layer(nx, 0.6 / nx, 0.015 * 64 / nx, 0.008 * 64 / nx,
                        stencil=True)
    np.testing.assert_array_equal(_np(xt), _np(xj))
    _same_topology(st, sj)
    assert float(st.dhat) == float(sj.dhat)
    big, _ = scenes.cloth_two_layer(64, CPU)
    assert float(big.dhat) == np.float32(0.008)
    with pytest.raises(ValueError):
        TC.build_grid_stencil(st, ((0, nx, nx), (nx * nx, nx, nx - 1)))
    # a stencil of 36 vertices on a sim of 72 (test_cloth.py's guard)
    one, x1 = TC.make_cloth_grid(nx, nx, 0.05, device=CPU)
    bad = dataclasses.replace(st, stencil=one.stencil)
    with pytest.raises(ValueError, match="stale"):
        TC.cloth_energy(bad, xt)
    with pytest.raises(ValueError):
        TC.build_grid_stencil(one, ((0, nx, nx), (nx * nx, 1, 1)))


# ---------------------------------------------------------------------------
# energy, gradient, Hessian-vector product
# ---------------------------------------------------------------------------

def _grad_t(f, y):
    z = torch.from_numpy(y).requires_grad_(True)
    return torch.autograd.grad(f(z), z)[0]


@pytest.mark.parametrize("form", ["stencil", "incidence", "scatter"])
def test_energy_and_gradient(form):
    sj, xj = JC.make_cloth_grid(9, 7, 0.05, dhat=0.008, kappa=50.0,
                                height=0.005)
    if form != "stencil":
        sj = dataclasses.replace(sj, stencil=None)
    if form == "scatter":
        sj = dataclasses.replace(sj, edge_inc=None, hinge_inc=None)
    st = interop.cloth_from_jax(sj, CPU)
    y = _perturbed(xj, 0.01, 0)
    p = _perturbed(np.zeros_like(y), 1.0, 1)
    energy = lambda z: JC.cloth_energy(sj, z)
    # the exact Hessian-vector product: JAX's jvp of grad against the
    # port's double backward
    e_j, g_j, hv_j = jax.jit(lambda z, q: (
        energy(z), jax.grad(energy)(z),
        jax.jvp(jax.grad(energy), (z,), (q,))[1]))(jnp.asarray(y),
                                                  jnp.asarray(p))
    e_t = float(TC.cloth_energy(st, torch.from_numpy(y)))
    np.testing.assert_allclose(e_t, float(e_j), rtol=E_RTOL)
    _close(_grad_t(lambda z: TC.cloth_energy(st, z), y), g_j)
    z = torch.from_numpy(y).requires_grad_(True)
    g = torch.autograd.grad(TC.cloth_energy(st, z), z, create_graph=True)[0]
    _close(torch.autograd.grad(g, z, torch.from_numpy(p))[0], hv_j)


# ---------------------------------------------------------------------------
# self-contact candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,mc", [(5, 8), (24, 24), (24, 3)])
def test_self_contact_candidates(nx, mc):
    """Both branches: the brute-force table at 5 x 5 (64 triangles) and
    the decomposed banded join at 24 x 24 (2,116); mc = 3 overflows."""
    sj, xj = _two_layer(nx, 0.05, 0.015, 0.02)
    st, xt = _pair(sj, xj)
    cj, oj = jax.jit(lambda x: JC.self_contact_candidates(sj, x, mc))(xj)
    ct, ot = TC.self_contact_candidates(st, xt, mc)
    assert ct.shape == (xt.shape[0], mc) and ct.dtype == torch.int32
    assert bool(ot) == bool(oj) == (mc == 3)
    if not bool(ot):
        assert _sets(ct) == _sets(cj)
        assert sum(map(len, _sets(ct))) > 100


# ---------------------------------------------------------------------------
# window contact, operator
# ---------------------------------------------------------------------------

@jit(static_argnames=("radius", "max_residue"))
def _jax_window_residue(sj, cand, radius, max_residue):
    """JAX's split of the candidates into the window's pairs and the
    residue, as one program (it sorts and counts: compiled, the same)."""
    return JC.classify_window_residue(
        sj, JC.ContactWindow(radius=radius, max_residue=max_residue), cand)


@pytest.fixture(scope="module")
def contact_state():
    """test_window_contact_matches_candidate_set's state: two 8 x 8 layers
    0.006 apart, dhat 0.008, perturbed by 0.002; candidates, the window's
    residue and friction multipliers in both packages."""
    sj, xj = _two_layer(8, 0.05, 0.006, 0.008, stencil=True)
    st, xt = _pair(sj, xj)
    y = _perturbed(xj, 0.002, 11)
    cj, _ = jax.jit(lambda z: JC.self_contact_candidates(sj, z, 8))(
        jnp.asarray(y))
    ct, ovf = TC.self_contact_candidates(st, torch.from_numpy(y), 8)
    assert not bool(ovf) and _sets(ct) == _sets(cj)
    cw_j = JC.ContactWindow(radius=1, max_residue=64)
    cw_t = TC.ContactWindow(radius=1, max_residue=64)
    rj = _jax_window_residue(sj, cj, 1, 64)
    rt = TC.classify_window_residue(st, cw_t, ct)
    lam = np.random.default_rng(3).uniform(0, 1, y.shape[0]).astype(
        np.float32)
    return dict(sj=sj, st=st, xj=xj, xt=xt, y=y, cj=cj, ct=ct, cw_j=cw_j,
                cw_t=cw_t, rj=rj, rt=rt, lam=lam)


def test_window_energy_against_dense(contact_state):
    s = contact_state
    st, y = s["st"], torch.from_numpy(s["y"])
    assert not bool(s["rt"][3]) and not bool(s["rj"][3])
    e_dense = float(TC.self_contact_energy(st, y, s["ct"]))
    assert e_dense > 0
    e_win = float(TC.window_contact_energy(st, s["cw_t"], y)
                  + TC._pair_contact_energy(st, y, *s["rt"][:3]))
    np.testing.assert_allclose(e_win, e_dense, rtol=E_RTOL)
    sj, cw, rj, cj = s["sj"], s["cw_j"], s["rj"], s["cj"]
    win_j = lambda z: JC.window_contact_energy(sj, cw, z)
    e_j, d_j, g_j = jax.jit(lambda z: (
        win_j(z) + JC._pair_contact_energy(sj, z, *rj[:3]),
        JC.self_contact_energy(sj, z, cj), jax.grad(win_j)(z)))(
            jnp.asarray(s["y"]))
    np.testing.assert_allclose(e_win, float(e_j), rtol=E_RTOL)
    np.testing.assert_allclose(e_dense, float(d_j), rtol=E_RTOL)
    _close(_grad_t(lambda z: TC.window_contact_energy(st, s["cw_t"], z),
                   s["y"]), g_j, rel=WIN_GRAD_REL)


@pytest.mark.parametrize("mode", ["plain", "dense", "window", "edge_list"])
def test_assembled_operator(contact_state, mode):
    """The assembled diagonal and four applications against JAX's."""
    s = contact_state
    sj, st = s["sj"], s["st"]
    kw_j, kw_t = dict(lam=jnp.asarray(s["lam"])), \
        dict(lam=torch.from_numpy(s["lam"]))
    if mode == "dense":
        kw_j["cand"], kw_t["cand"] = s["cj"], s["ct"]
    elif mode == "window":
        kw_j.update(window=s["cw_j"], window_res=s["rj"][:3])
        kw_t.update(window=s["cw_t"], window_res=s["rt"][:3])
    elif mode == "edge_list":
        sj = dataclasses.replace(sj, stencil=None)
        st = dataclasses.replace(st, stencil=None)
    ps = np.stack([_perturbed(np.zeros_like(s["y"]), 1.0, 20 + k)
                   for k in range(4)])

    def jax_side(y, x, ps):
        op = JC.assemble_operator(sj, y, x, DT, **kw_j)
        return op["diag"], jax.vmap(
            lambda p: JC.apply_operator(sj, op, p, DT))(ps)
    diag_j, q_j = jax.jit(jax_side)(jnp.asarray(s["y"]), s["xj"],
                                    jnp.asarray(ps))
    op_t = TC.assemble_operator(st, torch.from_numpy(s["y"]), s["xt"], DT,
                                **kw_t)
    _close(op_t["diag"], diag_j, what="diag")
    assert bool((op_t["diag"] > 0).all())
    for k in range(4):
        _close(TC.apply_operator(st, op_t, torch.from_numpy(ps[k]), DT),
               q_j[k], what=f"apply {k}")


def test_contact_budget_compaction(contact_state):
    """test_contact_active_set_compaction_matches_dense on the port: the
    compacted apply equals the dense one, the diagonal is unchanged, and
    the overflow flag fires exactly when live rows exceed the budget."""
    s = contact_state
    st, y = s["st"], torch.from_numpy(s["y"])
    kw = dict(cand=s["ct"], lam=torch.from_numpy(s["lam"]))
    dense = TC.assemble_operator(st, y, s["xt"], DT, **kw)
    n_live = int((dense["contact"][3] > 0).sum())
    assert n_live > 0
    comp = TC.assemble_operator(st, y, s["xt"], DT,
                                contact_budget=n_live + 3, **kw)
    assert comp["contact"] is None and comp["contact_c"] is not None
    assert not bool(comp["act_ovf"])
    torch.testing.assert_close(comp["diag"], dense["diag"], rtol=0, atol=0)
    for k in range(4):
        p = torch.from_numpy(_perturbed(np.zeros_like(s["y"]), 1.0, 30 + k))
        qd = TC.apply_operator(st, dense, p, DT)
        _close(TC.apply_operator(st, comp, p, DT), qd)
    tight = TC.assemble_operator(st, y, s["xt"], DT,
                                 contact_budget=n_live - 1, **kw)
    assert bool(tight["act_ovf"])
    ovf_j = jax.jit(lambda y: JC.assemble_operator(
        s["sj"], y, s["xj"], DT, cand=s["cj"], lam=jnp.asarray(s["lam"]),
        contact_budget=n_live - 1)["act_ovf"])(jnp.asarray(s["y"]))
    assert bool(ovf_j)


def test_assembled_equals_autodiff_where_gn_exact():
    """test_assembled_operator_matches_autodiff_where_gn_exact on the
    port: at the rest state the GN operator is the exact Hessian."""
    st, x0 = TC.make_cloth_grid(8, 8, 0.1, ground_off=-100.0, device=CPU)
    m3 = st.mass[:, None]
    dt = torch.tensor(0.02)
    p = torch.from_numpy(_perturbed(np.zeros(x0.shape, np.float32), 1.0, 3))
    z = x0.clone().requires_grad_(True)
    g = (m3 / (dt * dt)) * (z - x0) + torch.autograd.grad(
        TC.cloth_energy(st, z), z, create_graph=True)[0]
    hvp_auto = torch.autograd.grad(g, z, p)[0]
    op = TC.assemble_operator(st, x0, x0, dt)
    scale = hvp_auto.abs().max().item()
    torch.testing.assert_close(TC.apply_operator(st, op, p, dt), hvp_auto,
                               rtol=2e-3, atol=2e-4 * scale)


def test_window_residue_overflow_contract(contact_state):
    """A radius-0 window pushes the candidates into the residue: a tiny
    budget flags overflow (as JAX's), an ample one keeps the split
    exact."""
    s = contact_state
    st, y = s["st"], torch.from_numpy(s["y"])
    n_cand = int((s["ct"] >= 0).sum())
    assert n_cand > 4
    tiny_t = TC.ContactWindow(radius=0, max_residue=2)
    tiny_j = JC.ContactWindow(radius=0, max_residue=2)
    assert bool(TC.classify_window_residue(st, tiny_t, s["ct"])[3])
    assert bool(JC.classify_window_residue(s["sj"], tiny_j, s["cj"])[3])
    ample = TC.ContactWindow(radius=0, max_residue=n_cand + 8)
    vid, tidx, valid, ovf = TC.classify_window_residue(st, ample, s["ct"])
    assert not bool(ovf) and int(valid.sum()) > 0
    e_split = float(TC.window_contact_energy(st, ample, y)
                    + TC._pair_contact_energy(st, y, vid, tidx, valid))
    np.testing.assert_allclose(
        e_split, float(TC.self_contact_energy(st, y, s["ct"])), rtol=E_RTOL)


def test_bench_window_residue():
    """The bench's two-layer scene (dhat 0.85 of the spacing, layer B half
    a cell over A) with the layers in contact: a layer-A vertex's dhat box
    reaches layer-B triangles two cells away, outside a radius-1 window,
    so every layer-A vertex puts pairs in the residue, as many in JAX as in
    the port, and the bench's 1,024-pair budget overflows at 16 x 16 per
    layer already; radius 2 leaves no residue."""
    nx = 16
    st, x = scenes.cloth_two_layer(nx, CPU)
    n = nx * nx
    dhat = float(st.dhat)
    x = x.clone()
    x[n:, 1] = 0.2 + 0.5 * dhat                  # B resting on A
    cand, ovf = TC.self_contact_candidates(st, x, 32)
    assert not bool(ovf)
    sj, _ = _two_layer(nx, 0.6 / nx, 0.015 * 64 / nx, 0.008 * 64 / nx,
                       stencil=True)
    cj = jnp.asarray(_np(cand))
    for r, budget in ((1, 1024), (1, 10 ** 6), (2, 1024)):
        vid, _, valid, rovf = TC.classify_window_residue(
            st, TC.ContactWindow(r, budget), cand)
        _, _, valid_j, rovf_j = _jax_window_residue(sj, cj, r, budget)
        assert bool(rovf) == bool(rovf_j)
        assert int(valid.sum()) == int(np.asarray(valid_j).sum())
        if budget > 1024:
            live = vid[valid]
            assert live.numel() > 1024 and bool((live < n).all())
        else:
            assert bool(rovf) == (r == 1)


# ---------------------------------------------------------------------------
# implicit_step
# ---------------------------------------------------------------------------

def _friction_sheet():
    """test_ground_friction_arrests_sliding's sheet: 5 x 5 sliding at 0.5
    m/s in the barrier zone with friction 0.6."""
    sj, xj = JC.make_cloth_grid(5, 5, 0.05, height=0.008, k_stretch=2e2,
                                k_bend=1e-4, mass=0.01, dhat=0.02,
                                kappa=2.0, mu=0.6)
    return sj, xj, jnp.zeros_like(xj).at[:, 0].set(0.5)


# mode -> (scene, implicit_step keywords); the contact scenes are two 6 x 6
# layers 0.006 apart (inside dhat 0.008), so contact acts from step 1
MODES = {
    "assembled": ("sheet", dict(newton_iters=2, cg_iters=12)),
    "autodiff": ("sheet", dict(newton_iters=2, cg_iters=12,
                               operator="autodiff")),
    "dense": ("layers", dict(newton_iters=2, cg_iters=12,
                             self_contact=True)),
    "budget": ("layers", dict(newton_iters=1, cg_iters=12,
                              self_contact=True, contact_budget=144)),
    "window": ("layers", dict(newton_iters=1, cg_iters=12,
                              self_contact=True, contact_window="w")),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trajectory(mode):
    scene, kw = MODES[mode]
    if scene == "sheet":
        sj, xj, vj = _friction_sheet()
    else:
        sj, xj = _two_layer(6, 0.05, 0.006, 0.008, stencil=True)
        vj = jnp.zeros_like(xj)
        st, x = _pair(sj, xj)
        cand, _ = TC.self_contact_candidates(st, x, 8)
        assert TC.self_contact_energy(st, x, cand).item() > 0   # in contact
    kw_j, kw_t = dict(kw), dict(kw)
    if "contact_window" in kw:
        kw_j["contact_window"] = JC.ContactWindow(radius=1, max_residue=64)
        kw_t["contact_window"] = TC.ContactWindow(radius=1, max_residue=64)
    step = jax.jit(lambda x, v: JC.implicit_step(sj, x, v, DT, **kw_j))
    st, x = _pair(sj, xj)
    v = torch.from_numpy(_np(vj))
    iters = []
    for k in range(STEPS):
        out_j = step(xj, vj)
        xj, vj = out_j[0], out_j[1]
        out_t = TC.implicit_step(st, x, v, DT, with_stats=True, **kw_t)
        x, v = out_t[0], out_t[1]
        iters += out_t[-1]
        np.testing.assert_allclose(_np(x), _np(xj), **TRAJ,
                                   err_msg=f"{mode} step {k}")
        if kw.get("self_contact"):
            assert bool(out_t[2]) == bool(out_j[2])
            assert not bool(out_t[2])
    if scene == "sheet":
        assert max(iters) > 1          # the solves did work


def test_two_layers_no_interpenetration():
    """test_self_contact_two_layers_no_interpenetration on the port: layer
    B falls onto pinned layer A and stays above it; without self-contact
    it falls through."""
    sj, xj = _two_layer(5, 0.05, 0.02, 0.012)
    st, x0 = _pair(sj, xj)
    inner = np.asarray([25 + i * 5 + j for i in range(4) for j in range(4)])
    x, v = x0, torch.zeros_like(x0)
    for _ in range(40):
        x, v, ovf = TC.implicit_step(st, x, v, 0.01, newton_iters=2,
                                     cg_iters=40, self_contact=True)
        assert not bool(ovf)
        assert bool(torch.isfinite(x).all())
        assert x[inner, 1].min().item() > 0.2 - 1e-4, "penetrated A"
    assert x[inner, 1].min().item() < 0.2 + 3 * 0.012
    x, v = x0, torch.zeros_like(x0)
    for _ in range(40):
        x, v = TC.implicit_step(st, x, v, 0.01)
    assert x[25:, 1].min().item() < 0.2 - 0.02


@pytest.mark.cuda
def test_card_against_cpu():
    """The window and dense steps of the two-layer bench scene at 16 x 16
    per layer on the card against the CPU port, 3 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim_c, x_c = scenes.cloth_two_layer(16, CPU)
    sim_g, x_g = scenes.cloth_two_layer(16, torch.device("cuda"))
    cw = TC.ContactWindow(radius=1, max_residue=256)
    for window in (cw, None):
        xc, vc = x_c, torch.zeros_like(x_c)
        xg, vg = x_g, torch.zeros_like(x_g)
        for _ in range(3):
            xc, vc, oc = TC.implicit_step(
                sim_c, xc, vc, DT, newton_iters=2, cg_iters=24,
                self_contact=True, max_cand=32, contact_window=window)
            xg, vg, og = TC.implicit_step(
                sim_g, xg, vg, DT, newton_iters=2, cg_iters=24,
                self_contact=True, max_cand=32, contact_window=window)
            assert bool(oc) == bool(og)
            torch.testing.assert_close(xg.cpu(), xc, **TRAJ)
