"""The port's multi-device layer on torch.distributed (zpc_tpu_torch.parallel
.mesh, sim.distributed, sim.domain_decomp) against zpc_tpu on the same
seeded numpy inputs.

One rank runs in this process (gloo, a ``file://`` rendezvous); 2, 4 and 8
ranks run as spawned processes (tests/_torch_dist_worker.py, no JAX), one
group of each size running all its cases, compared with JAX's steps on a
mesh of the same size from conftest's 8 virtual devices.  Every process
group has a timeout and every spawned rank a deadline, so a hang fails a
test and does not hold the suite.

Tolerances, those of tests/test_distributed.py and
tests/test_domain_decomp.py: the sharded step x 1e-6, v 1e-5 (the table
count equal, the grid mass rtol 1e-5); the DD step x 1e-6, v 2e-4, F 1e-5
after one step, x 1e-5, v 5e-4 over several steps with migration.  The
DD ring statistics (live rows per hop of each ring, row and wire bytes)
and the overflow flags equal JAX's number by number.
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from zpc_tpu_torch import interop
from zpc_tpu_torch.models.constitutive import FixedCorotated as TFC
from zpc_tpu_torch.parallel import mesh as TMesh
from zpc_tpu_torch.sim import distributed as TS
from zpc_tpu_torch.sim import domain_decomp as TD
from zpc_tpu_torch.sim import mpm as TM

# the cuda test runs where JAX is absent (`pytest --noconftest -m cuda` on
# the card's machine); every other test needs zpc_tpu
try:
    import jax
    import jax.numpy as jnp
    from zpc_tpu.models.constitutive import FixedCorotated as JFC
    from zpc_tpu.parallel.mesh import make_mesh as jax_mesh
    from zpc_tpu.sim import distributed as JS
    from zpc_tpu.sim import domain_decomp as JD
    from zpc_tpu.sim import mpm as JM
except ImportError:
    pass

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
DEADLINE = 420          # seconds for a spawned group to finish


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def group1(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    TMesh.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                                 device=CPU,
                                 timeout=datetime.timedelta(seconds=60))
    try:
        yield TMesh.make_mesh(1)
    finally:
        dist.destroy_process_group()


# -- scenes (tests/test_domain_decomp.py's _setup, both packages) -----------

def _inputs(seed, n, spread=(0.1, 0.9), vel_scale=0.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(*spread, (n, 3)).astype(np.float32)
    v = (rng.standard_normal((n, 3)) * vel_scale).astype(np.float32)
    return {"x": x, "v": v}


def _port_scene(arrays, dx, block_capacity, device=CPU):
    st = TM.make_mpm_state(arrays["x"], dx=dx, device=device,
                           block_capacity=block_capacity,
                           velocity=arrays["v"])
    sim = TM.MPMSim(TFC.from_young_poisson(1e4, 0.3, device=device),
                    torch.tensor([0.0, -9.8, 0.0], device=device))
    return sim, st


def _jax_scene(arrays, dx, block_capacity):
    st = JM.make_mpm_state(jnp.asarray(arrays["x"]), dx=dx,
                           block_capacity=block_capacity)
    st = dataclasses.replace(st, particles=st.particles.update(
        v=jnp.asarray(arrays["v"])))
    sim = JM.MPMSim(model=JFC.from_young_poisson(1e4, 0.3),
                    gravity=jnp.asarray([0.0, -9.8, 0.0]))
    return sim, st


def _port_oracle(arrays, dx, block_capacity, dt, steps):
    sim, st = _port_scene(arrays, dx, block_capacity)
    for _ in range(steps):
        st = TM.explicit_step(sim, st, dt)
    n = len(arrays["x"])
    return {k: st.particles[k][:n].numpy() for k in ("x", "v", "F")}


def _spawn(job, world, cases, arrays):
    """Run ``cases`` on ``world`` spawned ranks; rank 0's outputs."""
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump(cases, f)
    for i, a in enumerate(arrays):
        if a is not None:
            np.savez(os.path.join(job, f"in_{i}.npz"), **a)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "MASTER_", "WORLD_SIZE",
                                "RANK"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, job, str(world),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=HERE)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=DEADLINE)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    return [dict(np.load(os.path.join(job, f"out_{i}.npz")))
            for i in range(len(cases))]


# -- JAX's runs of the same cases ----------------------------------------------

def _jax_sharded(arrays, D, dx, block_capacity, dt, steps):
    sim, st = _jax_scene(arrays, dx, block_capacity)
    mesh = jax_mesh(D)
    step = jax.jit(lambda s: JS.explicit_step_sharded(
        sim, s, jnp.float32(dt), mesh))
    s = JS.shard_state(st, mesh)
    for _ in range(steps):
        s = step(s)
    return {"x": np.asarray(s.particles["x"]),
            "v": np.asarray(s.particles["v"]),
            "table_count": int(s.grid.table.count),
            "mass": float(jnp.sum(s.grid.data["m"]))}


def _jax_dd(arrays, D, case):
    """JAX's DD steps of a case, with the same recovery rule as the
    worker's."""
    sim, st = _jax_scene(arrays, case["dx"], case["block_capacity"])
    mesh = jax_mesh(D)

    def make(nb, mig):
        return jax.jit(lambda s: JD.explicit_step_dd(
            sim, s, jnp.float32(case["dt"]), mesh, grid_template=st.grid,
            nb_local=nb, mig_cap=mig, with_stats=True))
    step = make(case["nb_local"], case["mig_cap"])
    retry = case.get("retry")
    step_big = make(retry["nb_local"], retry["mig_cap"]) if retry else None
    dds = JD.make_dd_state(st, mesh)
    first, flags, recovered = [], [], 0
    rows = {"fwd_rows": [], "ret_rows": [], "mig_rows": [],
            "wire_fwd": [], "wire_ret": [], "wire_mig": []}
    for _ in range(case["steps"]):
        nxt, ov, stats = step(dds)
        first.append(bool(ov))
        if bool(ov) and retry is not None:
            recovered += 1
            nxt, ov, stats = step_big(dds)
        flags.append(bool(ov))
        dds = nxt
        for k in ("fwd_rows", "ret_rows", "mig_rows"):
            rows[k].append(np.asarray(stats[k]))
        for k, v in stats["hop_wire_bytes"].items():
            rows[f"wire_{k}"].append(v)
    out = {"first_overflow": np.asarray(first), "overflow": np.asarray(flags),
           "recovered": recovered, **{k: np.stack(v) for k, v in rows.items()},
           "stats": stats}
    out.update({f"p_{k}": v for k, v in JD.gather_dd_particles(
        dds, len(arrays["x"])).items()})
    return out


def _same_stats(port, ref):
    """The port's ring statistics equal JAX's number by number."""
    for k in ("first_overflow", "overflow", "fwd_rows", "ret_rows",
              "mig_rows", "wire_fwd", "wire_ret", "wire_mig"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert int(port["recovered"]) == ref["recovered"]
    for k in ("fwd_row_bytes", "ret_row_bytes", "mig_row_bytes"):
        assert int(port[k]) == ref["stats"][k], k


# -- the mesh layer ------------------------------------------------------------

def test_initialize_without_a_cluster_is_single_process(monkeypatch):
    """No arguments and no MASTER_ADDR: a single-process run, nothing
    joined (JAX's no-op); half the arguments raise."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert not dist.is_initialized()
    TMesh.initialize_distributed(device=CPU)
    assert not dist.is_initialized()
    assert TMesh.process_info() == (0, 1, 1)
    with pytest.raises(ValueError):
        TMesh.initialize_distributed("tcp://127.0.0.1:1", device=CPU)


def test_mesh_helpers_one_rank(group1):
    mesh = group1
    assert mesh.mesh_dim_names == ("d",) and mesh.size() == 1
    with pytest.raises(ValueError):
        TMesh.make_mesh(2)
    full = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(TMesh.shard_leading(mesh, full), full)
    assert torch.equal(TMesh.replicated(mesh, full), full)
    assert torch.equal(TMesh.global_array(mesh, full), full)
    assert torch.equal(TMesh.local_to_global_index(mesh, 5),
                       torch.arange(5))
    assert TMesh.process_info() == (0, 1, 1)
    assert TMesh.mesh_device(mesh) == CPU


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank group of 2: the mesh case, the sharded cases, the dense
    cluster."""
    return _spawned_group(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawned_group(tmp_path_factory, 4)


SHARDED = [dict(n=256, seed=0, steps=1), dict(n=1024, seed=1, steps=3)]
DENSE = dict(kind="dd", dx=0.05, block_capacity=1024, dt=1e-4, steps=2,
             nb_local=128, mig_cap=512)


def _spawned_group(tmp_path_factory, world):
    cases, arrays = [{"kind": "mesh"}], [None]
    for c in SHARDED:
        cases.append(dict(kind="sharded", dx=0.05, block_capacity=256,
                          dt=1e-4, steps=c["steps"]))
        arrays.append(_inputs(c["seed"], c["n"], (0.3, 0.7)))
    cases.append(DENSE)
    arrays.append(_inputs(4, 256, (0.4, 0.5)))
    outs = _spawn(str(tmp_path_factory.mktemp(f"ranks{world}")), world,
                  cases, arrays)
    return world, outs, arrays


@pytest.mark.parametrize("group", ["two_ranks", "four_ranks"])
def test_mesh_helpers_spawned(group, request):
    world, outs, _ = request.getfixturevalue(group)
    out = outs[0]
    full = np.arange(4 * world * 3, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(out["gathered"], full)
    np.testing.assert_array_equal(out["replicated"], full)
    # rank r holds r + 1 rows: its global indices follow the earlier ranks'
    idx = out["global_index"].reshape(world, world)
    for r in range(world):
        start = r * (r + 1) // 2
        np.testing.assert_array_equal(idx[r, :r + 1],
                                      np.arange(start, start + r + 1))
    np.testing.assert_array_equal(out["info"], [0, world, 1])


# -- the sharded step ------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(SHARDED)))
def test_sharded_one_rank(group1, case):
    """At one rank (in this process) the sharded step is the explicit step,
    and JAX's sharded step on a mesh of one device agrees."""
    c = SHARDED[case]
    a = _inputs(c["seed"], c["n"], (0.3, 0.7))
    sim, st = _port_scene(a, 0.05, 256)
    s = TS.shard_state(st, group1)
    for _ in range(c["steps"]):
        s = TS.explicit_step_sharded(sim, s, 1e-4, group1)
    ref = _port_oracle(a, 0.05, 256, 1e-4, c["steps"])
    np.testing.assert_allclose(s.particles["x"].numpy(), ref["x"], atol=1e-6)
    np.testing.assert_allclose(s.particles["v"].numpy(), ref["v"], atol=1e-5)
    jx = _jax_sharded(a, 1, 0.05, 256, 1e-4, c["steps"])
    np.testing.assert_allclose(s.particles["x"].numpy(), jx["x"], atol=1e-6)
    np.testing.assert_allclose(s.particles["v"].numpy(), jx["v"], atol=1e-5)
    assert int(s.grid.table.count) == jx["table_count"]


@pytest.mark.parametrize("group", ["two_ranks", "four_ranks"])
@pytest.mark.parametrize("case", range(len(SHARDED)))
def test_sharded_spawned(group, case, request):
    """tests/test_distributed.py's two cases at 2 and 4 ranks: the
    gathered particles against JAX's sharded step on a mesh of the same
    size and against the explicit step; the union table's count and the
    replicated grid's mass equal JAX's."""
    world, outs, arrays = request.getfixturevalue(group)
    c = SHARDED[case]
    out, a = outs[1 + case], arrays[1 + case]
    jx = _jax_sharded(a, world, 0.05, 256, 1e-4, c["steps"])
    ref = _port_oracle(a, 0.05, 256, 1e-4, c["steps"])
    assert np.isfinite(out["v"]).all()
    for want in (jx, ref):
        np.testing.assert_allclose(out["x"], want["x"], atol=1e-6)
        np.testing.assert_allclose(out["v"], want["v"], atol=1e-5)
    assert int(out["table_count"]) == jx["table_count"]
    np.testing.assert_allclose(float(out["mass"]), jx["mass"], rtol=1e-5)


# -- the domain-decomposed step ----------------------------------------------

@pytest.mark.parametrize("group", ["two_ranks", "four_ranks"])
def test_dd_dense_cluster(group, request):
    """All particles in one tight cluster: one rank owns nearly every
    block, the others idle; v within 2e-4 of the explicit step, flags
    and ring statistics equal JAX's at the same number of ranks."""
    world, outs, arrays = request.getfixturevalue(group)
    out, a = outs[-1], arrays[-1]
    assert not out["overflow"].any()
    ref = _port_oracle(a, 0.05, 1024, 1e-4, 2)
    np.testing.assert_allclose(out["p_v"], ref["v"], atol=2e-4)
    jx = _jax_dd(a, world, DENSE)
    np.testing.assert_allclose(out["p_v"], jx["p_v"], atol=2e-4)
    _same_stats(out, jx)


DD8 = {
    "one_step": (dict(n=768, seed=10), dict(dt=1e-4, steps=1, nb_local=256,
                                            mig_cap=512)),
    "migration": (dict(n=512, seed=11, vel_scale=3.0),
                  dict(dt=2e-3, steps=4, nb_local=256, mig_cap=512)),
    "mig_overflow": (dict(n=512, seed=12, vel_scale=5.0),
                     dict(dt=5e-3, steps=3, nb_local=256, mig_cap=1)),
    "recovery": (dict(n=2048, seed=13, spread=(0.3, 0.7), vel_scale=40.0),
                 dict(dt=2e-3, steps=1, nb_local=512, mig_cap=2,
                      retry=dict(nb_local=512, mig_cap=1024))),
    "table_overflow": (dict(n=1024, seed=14, spread=(0.05, 0.95)),
                       dict(dx=0.02, dt=1e-4, steps=1, nb_local=16,
                            mig_cap=256)),
}


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Rank group of 8 (tests/test_domain_decomp.py's mesh): the DD cases
    and tests/_dd_scale_scenario.py's recovery contract."""
    sys.path.insert(0, HERE)
    import _dd_scale_scenario as sc
    cases, arrays = [], []
    for scene, step in DD8.values():
        cases.append(dict(kind="dd", dx=step.get("dx", 0.05),
                          block_capacity=1024, **{
                              k: v for k, v in step.items() if k != "dx"}))
        arrays.append(_inputs(scene["seed"], scene["n"],
                              scene.get("spread", (0.1, 0.9)),
                              scene.get("vel_scale", 0.0)))
    _, st = sc.build()
    cases.append(dict(kind="dd", dx=sc.DX, block_capacity=4096, dt=sc.DT,
                      steps=sc.STEPS, nb_local=sc.NB_SMALL,
                      mig_cap=sc.MIG_CAP,
                      retry=dict(nb_local=sc.NB_BIG, mig_cap=sc.MIG_CAP)))
    arrays.append({"x": np.asarray(st.particles["x"]),
                   "v": np.asarray(st.particles["v"])})
    outs = _spawn(str(tmp_path_factory.mktemp("ranks8")), 8, cases, arrays)
    return dict(zip(list(DD8) + ["scale"], zip(cases, outs, arrays)))


@pytest.fixture(scope="module")
def eight_ranks_jax(eight_ranks):
    return {name: _jax_dd(a, 8, case)
            for name, (case, _, a) in eight_ranks.items() if name != "scale"}


def test_dd_one_step_matches_oracle(eight_ranks, eight_ranks_jax):
    case, out, a = eight_ranks["one_step"]
    assert not out["overflow"].any()
    ref = _port_oracle(a, 0.05, 1024, case["dt"], 1)
    for want, pre in ((ref, ""), (eight_ranks_jax["one_step"], "p_")):
        np.testing.assert_allclose(out["p_x"], want[pre + "x"], atol=1e-6)
        np.testing.assert_allclose(out["p_v"], want[pre + "v"], atol=2e-4)
        np.testing.assert_allclose(out["p_F"], want[pre + "F"], atol=1e-5)


def test_dd_multi_step_with_migration(eight_ranks, eight_ranks_jax):
    case, out, a = eight_ranks["migration"]
    assert not out["overflow"].any()
    ref = _port_oracle(a, 0.05, 1024, case["dt"], 4)
    for want, pre in ((ref, ""), (eight_ranks_jax["migration"], "p_")):
        np.testing.assert_allclose(out["p_x"], want[pre + "x"], atol=1e-5)
        np.testing.assert_allclose(out["p_v"], want[pre + "v"], atol=5e-4)


def test_dd_migration_actually_happens(eight_ranks):
    """Some particle changed rank over the 4 steps, none was lost."""
    _, out, _ = eight_ranks["migration"]
    cap = len(out["pid0"]) // 8

    def ranks(pid, alive):
        return {int(p): i // cap for i, p in enumerate(pid) if alive[i]}
    r0 = ranks(out["pid0"], out["alive0"])
    r1 = ranks(out["pid1"], out["alive1"])
    assert r0.keys() == r1.keys() == set(range(512))
    assert sum(r0[p] != r1[p] for p in r0) > 0
    assert out["mig_rows"].sum() > 0


def test_dd_mig_overflow_detected(eight_ranks, eight_ranks_jax):
    """A bundle of one row overflows under fast particles, on the steps
    JAX's does."""
    _, out, _ = eight_ranks["mig_overflow"]
    assert out["overflow"].any()
    np.testing.assert_array_equal(out["overflow"],
                                  eight_ranks_jax["mig_overflow"]["overflow"])


def test_dd_stats_shape_and_locality(eight_ranks, eight_ranks_jax):
    """tests/test_domain_decomp.py's comm-volume checks on the port's
    statistics, which equal JAX's number by number."""
    case, out, _ = eight_ranks["one_step"]
    D = 8
    fwd, ret, mig = out["fwd_rows"][0], out["ret_rows"][0], \
        out["mig_rows"][0]
    assert fwd.shape == (D - 1,)
    assert (np.diff(fwd) <= 0).all() and (np.diff(mig) <= 0).all()
    assert fwd[0] > 0
    assert fwd[0] < 0.5 * D * case["nb_local"]
    assert (ret == ret[0]).all() and ret[0] > 0
    assert int(out["fwd_row_bytes"]) == 4 + 64 * 4 * 4
    assert int(out["ret_row_bytes"]) == 4 + 64 * 3 * 4
    assert int(out["wire_fwd"][0]) == D * case["nb_local"] * \
        int(out["fwd_row_bytes"])
    _same_stats(out, eight_ranks_jax["one_step"])


@pytest.mark.parametrize("name", ["migration", "mig_overflow",
                                  "table_overflow"])
def test_dd_stats_equal_jax(eight_ranks, eight_ranks_jax, name):
    _same_stats(eight_ranks[name][1], eight_ranks_jax[name])


def test_dd_mig_cap_overflow_fires_and_recovers(eight_ranks,
                                                eight_ranks_jax):
    """Two rows of bundle overflow under extreme velocities; the same step
    rerun from the same input with 1,024 rows (the host's recovery)
    holds, and matches the explicit step."""
    case, out, a = eight_ranks["recovery"]
    assert out["first_overflow"][0] and not out["overflow"][0]
    assert int(out["recovered"]) == 1
    ref = _port_oracle(a, 0.05, 1024, case["dt"], 1)
    np.testing.assert_allclose(out["p_x"], ref["x"], atol=1e-5)
    _same_stats(out, eight_ranks_jax["recovery"])


def test_dd_block_table_overflow_fires(eight_ranks):
    """16 local rows, far below the touched blocks, overflow."""
    assert eight_ranks["table_overflow"][1]["overflow"][0]


def test_dd_scale_recovery_contract(eight_ranks):
    """tests/_dd_scale_scenario.py at 8 ranks: 100,000 skewed particles
    marching across the splits; NB_SMALL overflows, the step reruns with
    NB_BIG from the same input, the comm-stat digest equals JAX's on 8
    devices exactly, and x, v match JAX's single-device trajectory."""
    import _dd_scale_scenario as sc
    case, out, _ = eight_ranks["scale"]
    sim, st = sc.build()
    ref_x, ref_v = sc.oracle(sim, st)
    dds, n_rec, stats_all = sc.run_dd(sim, st, jax_mesh(8))
    assert n_rec >= 1 and int(out["recovered"]) == n_rec
    assert not out["overflow"].any()
    port_stats = [{
        "fwd_rows": out["fwd_rows"][s], "ret_rows": out["ret_rows"][s],
        "mig_rows": out["mig_rows"][s],
        "fwd_row_bytes": int(out["fwd_row_bytes"]),
        "ret_row_bytes": int(out["ret_row_bytes"]),
        "hop_wire_bytes": {k: int(out[f"wire_{k}"][s])
                           for k in ("fwd", "ret", "mig")}}
        for s in range(sc.STEPS)]
    assert sc.stats_digest(port_stats) == sc.stats_digest(stats_all)
    np.testing.assert_allclose(out["p_x"], ref_x, atol=1e-5)
    np.testing.assert_allclose(out["p_v"], ref_v, atol=5e-4)


def test_dd_one_rank(group1):
    """At one rank (the state carried from JAX's by interop) the rings have
    no hop and the step still runs, equal to the explicit step within the
    one-step tolerances; the statistics are empty rows.  (JAX's step raises at one device: its ring loops index a
    [0] row array while tracing.)"""
    a = _inputs(10, 768)
    jsim, jst = _jax_scene(a, 0.05, 1024)
    sim, st = interop.sim_from_jax(jsim, CPU), interop.state_from_jax(jst,
                                                                       CPU)
    dds = TD.make_dd_state(st, group1)
    out = TD.explicit_step_dd(sim, dds, 1e-4, group1, grid_template=st.grid,
                              nb_local=256, mig_cap=512)
    assert len(out) == 2 and not bool(out[1])
    dds, ov, stats = TD.explicit_step_dd(sim, out[0], 1e-4, group1,
                                         grid_template=st.grid,
                                         nb_local=256, mig_cap=512,
                                         with_stats=True)
    assert stats["fwd_rows"].shape == (0,) and not bool(ov)
    got = TD.gather_dd_particles(dds, 768, group1)
    ref = _port_oracle(a, 0.05, 1024, 1e-4, 2)
    np.testing.assert_allclose(got["x"], ref["x"], atol=1e-6)
    np.testing.assert_allclose(got["v"], ref["v"], atol=2e-4)
    mesh = jax_mesh(1)
    with pytest.raises(IndexError):
        jax.jit(lambda s: JD.explicit_step_dd(
            jsim, s, jnp.float32(1e-4), mesh, grid_template=jst.grid,
            nb_local=256, mig_cap=512))(JD.make_dd_state(jst, mesh))


def test_dd_rejects_2d_and_flip(group1):
    """The decomposition is 3-D (a ValueError, not an assert that -O
    strips) and APIC only."""
    rng = np.random.default_rng(3)
    st2 = TM.make_mpm_state(rng.uniform(0.4, 0.6, (64, 2)), dx=0.05,
                            device=CPU)
    sim2 = TM.MPMSim(TFC.from_young_poisson(1e4, 0.3, device=CPU),
                     torch.tensor([0.0, -9.8]))
    with pytest.raises(ValueError, match="3-D"):
        TD.explicit_step_dd(sim2, None, 1e-4, group1, grid_template=st2.grid,
                            nb_local=64)
    sim, st = _port_scene(_inputs(0, 64), 0.05, 256)
    with pytest.raises(ValueError, match="APIC"):
        TD.explicit_step_dd(dataclasses.replace(sim, flip=0.5),
                            TD.make_dd_state(st, group1), 1e-4, group1,
                            grid_template=st.grid, nb_local=64)


@pytest.mark.cuda
def test_card_one_rank(tmp_path):
    """chip_smoke phase 38 at a small size: NCCL at world size 1 on the
    card; the sharded and DD steps equal the card's explicit step within
    the one-step tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    TMesh.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                                 device=dev,
                                 timeout=datetime.timedelta(seconds=60))
    try:
        mesh = TMesh.make_mesh(1)
        a = _inputs(10, 4096, (0.3, 0.7))
        sim, st = _port_scene(a, 1 / 32, 1024, dev)
        ref = st
        for _ in range(3):
            ref = TM.explicit_step(sim, ref, 1e-4)
        s = TS.shard_state(st, mesh)
        dds = TD.make_dd_state(st, mesh)
        for _ in range(3):
            s = TS.explicit_step_sharded(sim, s, 1e-4, mesh)
            dds, ov = TD.explicit_step_dd(sim, dds, 1e-4, mesh,
                                          grid_template=st.grid,
                                          nb_local=1024)
            assert not bool(ov)
        got = TD.gather_dd_particles(dds, 4096, mesh)
        for x, v in ((s.particles["x"].cpu().numpy(),
                      s.particles["v"].cpu().numpy()), (got["x"], got["v"])):
            np.testing.assert_allclose(x, ref.particles["x"].cpu().numpy(),
                                       atol=1e-6)
            np.testing.assert_allclose(v, ref.particles["v"].cpu().numpy(),
                                       atol=2e-4)
    finally:
        dist.destroy_process_group()
