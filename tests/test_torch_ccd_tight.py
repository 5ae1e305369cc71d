"""The port's tight-inclusion CCD (zpc_tpu_torch.geometry.ccd_tight)
against zpc_tpu on the same seeded numpy queries, and against the JAX
test's analytic impacts.

The JAX package's corners are not the exact dyadics its design assumes:
XLA's fp32 ``exp2`` on the CPU is off by up to 9 ulps for n >= 13, so its
``k * exp2(-n)`` is not ``k * 2^-n``.  The port takes ``2^-n`` from an
exact table.  So the port is held to JAX with XLA's ``exp2`` values put
in that table: ``hit`` and ``overflowed`` equal, ``toi`` within 4 fp32
ulps of 1 (XLA contracts some of the gap function's multiply-adds, the
port rounds each operation).  With its own exact table the port passes
the JAX test's oracles: the analytic impact times (conservative, within
5e-4) and the dense-time brute force (never late by more than 1e-3, no
hit where the distance stays above 2e-2).  Iterations after every stack
emptied change nothing: the result does not depend on how often the loop
reads its exit flag.
"""

import numpy as np
import pytest
import torch

from zpc_tpu_torch.geometry import ccd_tight as TC
from zpc_tpu_torch.geometry.distance import (edge_edge_dist2,
                                             point_triangle_dist2)

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax.numpy as jnp
    from zpc_tpu.geometry import ccd_tight as JC
except ImportError:
    pass

TOI_ULPS = 4 * 2.0 ** -23
FNS = ("vertex_face_ccd", "edge_edge_ccd_tight")
# the JAX tests' settings, and a small stack and iteration cap that overflow
SETTINGS = (dict(tol=1e-5), dict(), dict(min_sep=1e-3, stack_size=8,
                                         max_iter=64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def xla_exp2(monkeypatch):
    """The port's 2^-n table replaced by XLA's exp2(-n) values."""
    n = jnp.arange(TC._N_MAX + 1, dtype=jnp.float32)
    monkeypatch.setattr(TC, "_POW2",
                        tuple(float(v) for v in np.asarray(jnp.exp2(-n))))


def _queries(seed, n):
    """tests/test_ccd_tight.py's random batch: 4 points and 4
    displacements per query, uniform in [-1, 1]^3, float32."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (4, n, 3)).astype(np.float32)
    disp = rng.uniform(-1, 1, (4, n, 3)).astype(np.float32)
    return [*pts, *disp]


def _port(fn, args, **kw):
    return getattr(TC, fn)(*map(torch.from_numpy, args), **kw)


def test_xla_exp2_is_not_exact():
    """The reference fault the port works around."""
    n = np.arange(TC._N_MAX + 1)
    xla = np.asarray(jnp.exp2(-jnp.asarray(n, jnp.float32)))
    assert (xla != (2.0 ** -n).astype(np.float32)).any()
    assert TC._POW2 == tuple(2.0 ** -n)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_against_jax(fn, setting, xla_exp2):
    kw = SETTINGS[setting]
    args = _queries(setting, 192)
    rj = getattr(JC, fn)(*map(jnp.asarray, args), **kw)
    rt = _port(fn, args, **kw)
    np.testing.assert_array_equal(rt.overflowed.numpy(),
                                  np.asarray(rj.overflowed))
    np.testing.assert_array_equal(rt.hit.numpy(), np.asarray(rj.hit))
    tj = np.asarray(rj.toi)
    hit = np.isfinite(tj)
    assert hit.any()
    np.testing.assert_allclose(rt.toi.numpy()[hit], tj[hit], rtol=0,
                               atol=TOI_ULPS)
    if setting == 2:
        assert rt.overflowed.any()      # the batch that overflows


_TRI = ([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]])
_Z = [[0.0, 0.0, 0.0]]
# tests/test_ccd_tight.py's analytic cases: (fn, points, displacements,
# kwargs, expected toi or None for a miss)
ANALYTIC = {
    "vf_direct_hit": ("vertex_face_ccd", ([[0.25, 0.25, 1.0]], *_TRI),
                      ([[0.0, 0.0, -2.0]], _Z, _Z, _Z), dict(tol=1e-5), 0.5),
    "vf_miss_outside": ("vertex_face_ccd", ([[2.0, 2.0, 1.0]], *_TRI),
                        ([[0.0, 0.0, -2.0]], _Z, _Z, _Z), {}, None),
    "vf_min_sep": ("vertex_face_ccd", ([[0.25, 0.25, 1.0]], *_TRI),
                   ([[0.0, 0.0, -2.0]], _Z, _Z, _Z),
                   dict(min_sep=0.2, tol=1e-5), 0.4),
    "vf_t0_contact": ("vertex_face_ccd", ([[0.25, 0.25, 0.0]], *_TRI),
                      ([[0.0, 0.0, 1.0]], _Z, _Z, _Z), {}, 0.0),
    "vf_moving_triangle": ("vertex_face_ccd", ([[0.25, 0.25, 1.0]], *_TRI),
                           (_Z, *[[[0.0, 0.0, 4.0]]] * 3), dict(tol=1e-5),
                           0.25),
    "ee_crossing": ("edge_edge_ccd_tight",
                    ([[-1.0, 0.0, 1.0]], [[1.0, 0.0, 1.0]],
                     [[0.0, -1.0, 0.0]], [[0.0, 1.0, 0.0]]),
                    ([[0.0, 0.0, -2.0]], [[0.0, 0.0, -2.0]], _Z, _Z),
                    dict(tol=1e-5), 0.5),
    "ee_parallel_miss": ("edge_edge_ccd_tight",
                         ([[-1.0, 0.0, 1.0]], [[1.0, 0.0, 1.0]],
                          [[-1.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]]),
                         ([[0.5, 0.0, 0.0]], [[0.5, 0.0, 0.0]], _Z, _Z),
                         {}, None),
}


@pytest.mark.parametrize("case", sorted(ANALYTIC))
def test_analytic(case):
    fn, pts, disp, kw, want = ANALYTIC[case]
    args = [np.asarray(a, np.float32) for a in (*pts, *disp)]
    r = _port(fn, args, **kw)
    if want is None:
        assert not bool(r.hit[0]) and np.isinf(float(r.toi[0]))
        return
    toi = float(r.toi[0])
    assert bool(r.hit[0]) and not bool(r.overflowed[0])
    if want == 0.0:
        assert toi == 0.0
    else:
        assert want - 5e-4 <= toi <= want + 1e-6


def _brute_first_hit(fn, args, q, nt=2000, thresh=1e-4):
    """Dense-time scan of query q: the first sampled t where the distance
    dips below ``thresh``, and the smallest distance (float64)."""
    a = [torch.from_numpy(x[q]).double() for x in args]
    t = torch.linspace(0.0, 1.0, nt, dtype=torch.float64)[:, None]
    xs = [a[k] + t * a[k + 4] for k in range(4)]
    dist = point_triangle_dist2 if fn == "vertex_face_ccd" else \
        edge_edge_dist2
    ds = torch.sqrt(dist(*xs)).numpy()
    hit = ds <= thresh
    return (float(t[np.argmax(hit), 0]) if hit.any() else None,
            float(ds.min()))


@pytest.mark.parametrize("fn", FNS)
def test_random_oracle(fn):
    args = _queries(11, 32)
    r = _port(fn, args, tol=1e-5)
    for q in range(32):
        t_true, dmin = _brute_first_hit(fn, args, q)
        if t_true is not None:
            assert bool(r.hit[q]), f"q={q} missed a real hit at {t_true}"
            assert float(r.toi[q]) <= t_true + 1e-3
        elif dmin > 2e-2:
            assert not bool(r.hit[q]), f"q={q} false hit dmin={dmin}"


@pytest.mark.parametrize("fn", FNS)
def test_exit_checks_change_nothing(fn, monkeypatch):
    args = _queries(5, 64)
    kw = dict(min_sep=1e-4, max_iter=200)
    monkeypatch.setattr(TC, "CHECK_EVERY", 1)
    r1 = _port(fn, args, **kw)
    monkeypatch.setattr(TC, "CHECK_EVERY", 64)
    r64 = _port(fn, args, **kw)
    assert r64.iters % 64 == 0 or r64.iters == 200
    assert r64.iters >= r1.iters
    for a, b in zip(r1[:3], r64[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_card_against_cpu():
    """Vertex-face and edge-edge queries on the card equal the CPU port's
    (every operation is rounded the same way on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _queries(2, 4096)
    for fn in FNS:
        c = _port(fn, args)
        g = getattr(TC, fn)(*(torch.from_numpy(a).cuda() for a in args))
        for a, b in zip(g[:3], c[:3]):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
        assert g.iters == c.iters
