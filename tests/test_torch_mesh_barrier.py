"""The mesh contact's narrow phase per bin (zpc_tpu_torch.ops.mesh_barrier
and MeshContact's forces, energy and times of impact over it).

No JAX: the plain version is held to a float64 all-pairs barrier written
here, and the kernel (marked ``cuda``) to the plain version.  Tolerances:

* the plain route (float32) against the float64 barrier over the
  100,352-triangle terrain: forces and Hessians within 1e-4 of their
  largest entries.  The lanes lie 0.1-1.5 dhat (1e-3 to 1.5e-2) above the
  terrain at coordinates near 0.5, where a float32 ulp is 6e-8, so a
  pair's p - c carries a relative rounding of up to ~1e-4 at the nearest
  lanes, whose entries are the largest;
* the plain route in blocks of any size: equal, bit for bit (each lane's
  sums run over its bin's candidates in slot order whatever the blocks);
* energy and times of impact, taken a few columns of candidate slots at a
  time, against the dense ``[B, K, max_tris]`` formula the port had
  before: the energy within 1e-6 relative (the order of the sum), the
  times equal (a minimum);
* the active pairs (d^2 < dhat^2) against the float64 count: within a
  thousandth, since a pair at d = dhat to within float32 rounding may fall
  either side;
* the kernel against the plain version on the CPU: the work counts equal;
  each force and Hessian entry within (2 n + 16) 2^-24 of the sum of its
  n terms' magnitudes (``term_magnitudes``), the most two float32 sums of
  the same terms in two orders can differ by, with a few roundings of
  each term apart.  The kernel is built without fused multiply-adds, so a
  pair's terms round as the plain version's operators do (up to the log's
  last bit); the Hessian's (j, i) entries are its (i, j) products.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch import scenes
from zpc_tpu_torch.geometry.contact import barrier, barrier_grad, barrier_hess
from zpc_tpu_torch.geometry.distance import (point_triangle_ccd,
                                             point_triangle_closest)
from zpc_tpu_torch.models.constitutive import FixedCorotated
from zpc_tpu_torch.ops import mesh_barrier as MB
from zpc_tpu_torch.sim import mpm_binned2 as b2
from zpc_tpu_torch.sim.contact_implicit import ContactSet, MeshContact
from zpc_tpu_torch.sim.mpm import MPMSim, make_mpm_state
from zpc_tpu_torch.utils import profile as P

CPU = torch.device("cpu")
DHAT, KAPPA = 0.01, 10.0          # portbench/configs/implicit_block_1m*.json
K = b2.K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _height(x, z):
    return 0.56 + 0.02 * np.sin(6.2832 * x) * np.cos(6.2832 * z)


@pytest.fixture(scope="module")
def terrain_bins():
    """4,096 particles at dx 1/128 over a 0.1 x 0.1 patch of the
    100,352-triangle terrain, 0.1-1.5 dhat above it, in 256 bins, with the
    broad phase of the configuration (max_tris 648, tile 3072)."""
    rng = np.random.default_rng(7)
    n = 4096
    x, z = rng.uniform(0.45, 0.55, n), rng.uniform(0.45, 0.55, n)
    y = _height(x, z) + rng.uniform(0.1, 1.5, n) * DHAT
    st = make_mpm_state(np.stack([x, y, z], -1).astype(np.float32),
                        dx=1.0 / 128, device=CPU, block_capacity=1024)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(5e4, 0.3,
                                                         device=CPU),
                 gravity=torch.tensor([0.0, -9.8, 0.0]))
    cfg = b2.BinnedConfig2(bins_capacity=256, block_capacity=1024)
    bst = b2.bin_state(sim, st, cfg)
    ctx = b2._make_ctx(bst, cfg)
    alive = ctx.alive.view(256, K)
    tri = scenes.terrain_mesh(224, CPU)
    mc = MeshContact.build(tri, DHAT, KAPPA, max_tris=648, tile=3072)
    return dict(mc=mc, ctx=ctx, alive=alive, tri=tri,
                xb=bst.cols[:, 0:3].view(256, K, 3))


def _all_pairs64(p, tri):
    """Float64 barrier force, GN Hessian and number of active pairs of the
    points ``p [N, 3]`` against every triangle of ``tri`` within dhat of
    their box (the others lie farther than dhat from every point)."""
    p, td = p.double(), tri.double()
    lo, hi = p.amin(0) - DHAT, p.amax(0) + DHAT
    T = td[((td.amax(1) >= lo) & (td.amin(1) <= hi)).all(-1)]
    dh2 = DHAT * DHAT
    f = torch.zeros_like(p)
    H = torch.zeros((p.shape[0], 3, 3), dtype=torch.float64)
    active = 0
    for s in range(0, p.shape[0], 256):
        q = p[s:s + 256, None]
        _, cl = point_triangle_closest(q, T[None, :, 0], T[None, :, 1],
                                       T[None, :, 2])
        d = q - cl
        d2 = (d * d).sum(-1)
        act = d2 < dh2
        active += int(act.sum())
        bg = torch.where(act, barrier_grad(d2, dh2, KAPPA), 0.0)
        bh = torch.where(act, barrier_hess(d2, dh2, KAPPA).clamp_min(0.0),
                         0.0)
        f[s:s + 256] = -((2.0 * bg)[..., None] * d).sum(1)
        H[s:s + 256] = ((4.0 * bh)[..., None, None] * d[..., :, None] *
                        d[..., None, :]).sum(1)
    return f, H, active


WORK = ("pairs", "lanes", "tris", "active")


def test_plain_route_matches_float64_all_pairs(terrain_bins):
    s = terrain_bins
    mc = s["mc"]
    live, hits, counts, band = mc._bin_query(s["ctx"], s["alive"])
    assert bool(band[live].all()) and int(counts.max()) <= 648
    assert int(counts.max()) > 32 * 4, "the lists should be long"
    cset = mc.broad_phase(s["ctx"], s["alive"])
    assert not bool(cset.overflow)
    before = {k: P.CONTACT_WORK[k] for k in WORK}
    with _profiler():
        fc, Hc = mc.forces_and_hessians(cset, s["xb"], s["alive"])
    f64, H64, active64 = _all_pairs64(s["xb"][s["alive"]], s["tri"])
    assert (f64.norm(dim=-1) > 0).sum() > 1000, "lanes in contact"
    for got, want in ((fc[s["alive"]], f64), (Hc[s["alive"]], H64)):
        err = (got.double() - want).abs().max()
        assert err <= 1e-4 * want.abs().max(), err / want.abs().max()
    assert not fc[~s["alive"]].any() and not Hc[~s["alive"]].any()
    # the narrow phase's work, added under a profiler as new tensors
    work = MB.mesh_barrier_reference(s["xb"], s["alive"], cset.hits,
                                     s["tri"], DHAT, KAPPA)[2]
    for i, k in enumerate(WORK):
        assert int(P.CONTACT_WORK[k] - before[k]) == int(work[i])
    nl = s["alive"].sum(1)
    assert int(work[0]) == int((nl * counts).sum())
    assert int(work[1]) == int(nl[counts > 0].sum())
    assert int(work[2]) == int(counts[nl > 0].sum())
    assert active64 > 1000 and int(work[3]) < int(work[0])
    assert abs(int(work[3]) - active64) <= 1e-3 * active64


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_contact_work_is_counted_under_a_profiler_only(terrain_bins):
    """Counted while a profiler runs, as the spans are; each value a new
    tensor, so a copy of the counter taken earlier keeps its values."""
    s = terrain_bins
    cset = s["mc"].broad_phase(s["ctx"], s["alive"])
    with _profiler():
        s["mc"].forces_and_hessians(cset, s["xb"], s["alive"])
    kept = dict(P.CONTACT_WORK)
    values = {k: int(v) for k, v in kept.items()}
    s["mc"].forces_and_hessians(cset, s["xb"], s["alive"])
    assert all(P.CONTACT_WORK[k] is kept[k] for k in kept)
    with _profiler():
        s["mc"].forces_and_hessians(cset, s["xb"], s["alive"])
    assert {k: int(v) for k, v in kept.items()} == values
    work = MB.mesh_barrier_reference(s["xb"], s["alive"], cset.hits,
                                     s["tri"], DHAT, KAPPA)[2]
    assert set(kept) >= set(WORK)
    for i, k in enumerate(WORK):
        assert P.CONTACT_WORK[k] is not kept[k]
        assert int(P.CONTACT_WORK[k]) == values[k] + int(work[i])


@pytest.mark.parametrize("pairs", [3 * K, 1 << 14])
def test_plain_blocks_do_not_change_the_result(terrain_bins, pairs,
                                               monkeypatch):
    s = terrain_bins
    hits = s["mc"].broad_phase(s["ctx"], s["alive"]).hits
    args = (s["xb"], s["alive"], hits, s["tri"], DHAT, KAPPA)
    monkeypatch.setattr(MB, "PAIRS", 1 << 30)
    whole = MB.mesh_barrier_reference(*args)
    monkeypatch.setattr(MB, "PAIRS", pairs)
    part = MB.mesh_barrier_reference(*args)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)


def _small_case(seed=3):
    """Eight bins over a small heightfield, lists of every length from
    empty to 24 with holes (not front-packed), dead lanes and a dead bin;
    lanes moving down through the terrain."""
    rng = np.random.default_rng(seed)
    tri = scenes.terrain_mesh(4, CPU, y0=0.3, amp=0.05)
    B, M = 8, tri.shape[0]
    xb = np.stack([rng.uniform(0.1, 0.9, (B, K)),
                   rng.uniform(0.25, 0.4, (B, K)),
                   rng.uniform(0.1, 0.9, (B, K))], -1).astype(np.float32)
    alive = rng.uniform(size=(B, K)) < 0.8
    alive[5] = False
    hits = np.full((B, 24), -1, np.int32)
    for b, n in enumerate((0, 1, 5, 24, 12, 24, 3, 17)):
        slots = np.sort(rng.choice(24, n, replace=False)) if b % 2 else \
            np.arange(n)
        hits[b, slots] = rng.choice(M, n, replace=False)
    dxb = rng.uniform(-0.05, 0.05, (B, K, 3)).astype(np.float32)
    dxb[..., 1] -= 0.15
    return (torch.from_numpy(xb), torch.from_numpy(alive),
            torch.from_numpy(hits), tri, torch.from_numpy(dxb))


def _dense(tri, hits, xb, alive, dhat):
    """The dense [B, K, max_tris] narrow phase: (active, diff, d2) and the
    slots' corners."""
    valid = hits >= 0
    tv = tri[hits.clamp_min(0).long()]
    _, cl = point_triangle_closest(
        xb[:, :, None, :], tv[:, None, :, 0], tv[:, None, :, 1],
        tv[:, None, :, 2])
    diff = xb[:, :, None, :] - cl
    d2 = torch.sum(diff * diff, -1)
    act = valid[:, None, :] & alive[..., None] & (d2 < dhat * dhat)
    return act, diff, d2, valid, tv


@pytest.mark.parametrize("pairs", [1 << 20, 5 * 8 * K])
def test_energy_and_toi_match_the_dense_formula(pairs, monkeypatch):
    """In one block of columns, and five columns of the eight bins at a
    time (the last block short)."""
    monkeypatch.setattr(MB, "PAIRS", pairs)
    xb, alive, hits, tri, dxb = _small_case()
    dhat = 0.05
    mc = MeshContact.build(tri, dhat, 2.0, max_tris=24)
    cset = ContactSet(hits, torch.zeros((), dtype=torch.bool))
    act, diff, d2, valid, tv = _dense(tri, hits, xb, alive, dhat)
    want = torch.where(act, barrier(d2, dhat * dhat, 2.0), 0.0).sum()
    got = mc.energy(cset, xb, alive)
    assert float(want) > 0
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    shape = xb.shape[:2] + (hits.shape[1], 3)
    zero3 = xb.new_zeros(()).expand(shape)
    ti = point_triangle_ccd(
        xb[:, :, None, :].expand(shape), tv[:, None, :, 0].expand(shape),
        tv[:, None, :, 1].expand(shape), tv[:, None, :, 2].expand(shape),
        dxb[:, :, None, :].expand(shape), zero3, zero3, zero3)
    want_t = torch.where(valid[:, None, :] & alive[..., None], ti,
                         1.0).amin(-1)
    got_t = mc.toi(cset, xb, dxb, alive)
    assert torch.equal(got_t, want_t)
    assert (got_t < 1).any() and (got_t[~alive] == 1).all()
    # and the forces, against the same dense formula
    bg = torch.where(act, barrier_grad(d2, dhat * dhat, 2.0), 0.0)
    bh = torch.where(act, barrier_hess(d2, dhat * dhat, 2.0).clamp_min(0.0),
                     0.0)
    fc, Hc = mc.forces_and_hessians(cset, xb, alive)
    f_want = -((2.0 * bg)[..., None] * diff).sum(2)
    H_want = ((4.0 * bh)[..., None, None] * diff[..., :, None] *
              diff[..., None, :]).sum(2)
    assert f_want.abs().max() > 0
    for g, w in ((fc, f_want), (Hc, H_want)):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------

def _special_triangles():
    """Axis-aligned triangles on dyadic coordinates (a lane on an edge or
    a vertex lies on it exactly), a sliver 1e-6 high, a needle, and
    degenerate ones: three equal corners, three corners on a line."""
    y = 0.5
    return torch.tensor([
        [[0.25, y, 0.25], [0.375, y, 0.25], [0.25, y, 0.375]],
        [[0.375, y, 0.25], [0.375, y, 0.375], [0.25, y, 0.375]],
        [[0.26, y, 0.3], [0.36, y, 0.3], [0.31, y, 0.300001]],
        [[0.3, y, 0.26], [0.3001, y, 0.36], [0.3, y + 1e-4, 0.36]],
        [[0.3, y, 0.3], [0.3, y, 0.3], [0.3, y, 0.3]],
        [[0.27, y, 0.27], [0.33, y, 0.33], [0.3, y, 0.3]],
    ], dtype=torch.float32)


def _kernel_case(seed=11):
    """96 bins over the 100,352-triangle terrain and the special
    triangles: lists of 0 to 648 candidates (the triangles nearest the
    bin's centre, some lists with holes), dead lanes and dead bins, lanes
    0-1.5 dhat from the terrain, and bins whose lanes sit on the special
    triangles' edges and vertices or near them."""
    rng = np.random.default_rng(seed)
    terrain = scenes.terrain_mesh(224, CPU)
    special = _special_triangles()
    tri = torch.cat([terrain, special])
    M0 = terrain.shape[0]
    cen = terrain.mean(1).numpy()
    B, T = 96, 648
    counts = np.concatenate([[0, 1, 2, 31, 32, 33, 127, 128, 129, 647, 648,
                              648], rng.integers(0, 649, B - 12)])
    xb = np.zeros((B, K, 3), np.float32)
    hits = np.full((B, T), -1, np.int32)
    alive = rng.uniform(size=(B, K)) < 0.85
    alive[[3, 40]] = False
    for b in range(B):
        c = rng.uniform(0.1, 0.9, 2)
        x = c[0] + rng.uniform(-0.02, 0.02, K)
        z = c[1] + rng.uniform(-0.02, 0.02, K)
        xb[b] = np.stack([x, _height(x, z) + rng.uniform(0, 1.5, K) * DHAT,
                          z], -1)
        near = np.argsort(((cen[:, [0, 2]] - c) ** 2).sum(1))[:counts[b]]
        slots = np.sort(rng.choice(T, counts[b], replace=False)) \
            if b % 3 == 0 else np.arange(counts[b])
        hits[b, slots] = rng.permutation(near)
    # special bins: every special triangle a candidate; lanes on the
    # corners and edge midpoints of the dyadic pair, on the degenerate
    # ones, and scattered within 1.5 dhat above and below all of them
    sp = special.numpy()
    on = np.concatenate([sp[:2].reshape(-1, 3),
                         0.5 * (sp[:2] + np.roll(sp[:2], 1, 1)).reshape(
                             -1, 3), sp[4:].reshape(-1, 3)])
    for b in (90, 91, 92, 93, 94, 95):
        hits[b] = -1
        hits[b, :6] = M0 + np.arange(6)
        if b == 93:
            hits[b, 6:300] = rng.choice(M0, 294, replace=False)
        pts = sp[rng.integers(0, 6, K)].mean(1) + np.stack([
            rng.uniform(-0.06, 0.06, K), rng.uniform(-1.5, 1.5, K) * DHAT,
            rng.uniform(-0.06, 0.06, K)], -1)
        pts[:on.shape[0]] = on
        xb[b] = pts
        alive[b] = True
    return (torch.from_numpy(xb), torch.from_numpy(alive),
            torch.from_numpy(hits), tri)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    xb, alive, hits, tri = _kernel_case()
    want = MB.mesh_barrier_reference(xb, alive, hits, tri, DHAT, KAPPA)
    mags = MB.term_magnitudes(xb, alive, hits, tri, DHAT, KAPPA)
    n = (hits >= 0).sum(1).double()[:, None, None]
    n0 = MB.LAUNCHES
    # the lanes as a view of wider columns (the step passes one) and whole
    cols = torch.cat([xb, torch.zeros(xb.shape[:2] + (4,))], -1).to(dev)
    for x in (cols[..., :3], xb.to(dev)):
        got = MB.mesh_barrier(x, alive.to(dev), hits.to(dev), tri.to(dev),
                              DHAT, KAPPA)
        torch.cuda.synchronize()
        assert torch.equal(got[2].cpu(), want[2])
        for g, w, m in zip(got[:2], want[:2], mags):
            g, w, m = (t.cpu().flatten(2).double() for t in (g, w, m))
            bound = (2.0 * n + 16.0) * 2.0 ** -24 * m
            assert ((g - w).abs() <= bound).all(), \
                ((g - w).abs() / bound).nan_to_num(0.0).max()
    assert MB.LAUNCHES == n0 + 2
    assert int(want[2][0]) > 0 and want[0][alive].abs().max() > 0
    assert not want[0][~alive].any()
