"""The large-mesh pieces of the benchmark: the plain reference's pruned
barrier against the all-pairs one, and the contact layer's three readers
(narrow and broad phase device time, the narrow phase's roofline) against
hand sums on a built slice."""

import numpy as np
import pytest
import torch

from portbench.harness import trace
from portbench.harness.spec import BENCH, load_cell, load_module

CELL = "implicit_block_1m_terrain100k.floor_contact"


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


def _barriers(res, n, seed):
    """(pruned, all-pairs) barrier force and Hessian of ``n`` particles
    near the cell's terrain made at ``res``, in float64."""
    cfg = dict(load_cell(CELL).config)
    cfg["obstacle"] = dict(cfg["obstacle"], res=res)
    from portbench.harness import inputs
    tri = inputs.obstacle(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.3, 0.7, n)
    z = rng.uniform(0.3, 0.7, n)
    y = 0.56 + 0.02 * np.sin(6.2832 * x) * np.cos(6.2832 * z) + \
        rng.uniform(-1.0, 4.0, n) * cfg["obstacle"]["dhat"]
    x0 = torch.from_numpy(np.stack([x, y, z], -1).astype(np.float32))
    dense = load_module(BENCH / "reference" / "dense_mpm.py")
    mesh = load_module(BENCH / "reference" / "dense_mpm_mesh.py")
    args = (cfg, x0, None, tri, 5e-4, torch.float64)
    return mesh.DenseMPMMesh(*args)._contact(), \
        dense.DenseMPM(*args)._contact()


@pytest.mark.parametrize("res,n,seed", [(96, 384, 1), (224, 96, 2)])
def test_pruned_barrier_equals_all_pairs(res, n, seed):
    (f, H), (f_all, H_all) = _barriers(res, n, seed)
    assert (f_all.norm(dim=-1) > 0).sum() > n // 8, "particles in reach"
    assert (f_all.norm(dim=-1) == 0).sum() > n // 8, "particles out of reach"
    for got, want in ((f, f_all), (H, H_all)):
        assert got.dtype == torch.float64
        err = (got - want).abs().max()
        assert err <= 1e-12 * want.abs().max(), err / want.abs().max()


def test_the_reference_imports_neither_the_program_nor_jax():
    src = (BENCH / "reference" / "dense_mpm_mesh.py").read_text()
    for name in ("zpc_tpu", "jax"):
        assert f"import {name}" not in src and f"from {name}" not in src


def _slice(**kw):
    base = dict(window_s=2.0, busy_s=1.5, span_device_s={"step": 2.5},
                steps=10, rebins=0, cg_iters=[4] * 10, window_steps=20,
                window_rebins=0,
                shapes={"particles": 10, "lanes": 1024,
                        "touched_blocks": 2, "segment_steps": 10},
                peaks={"hbm_bytes_per_s": 1e6, "fp32_flop_per_s": 1e9},
                program_spans={"zpc.contact.broad": (10, 0.05),
                               "zpc.contact.narrow": (10, 0.002)},
                counters={"HOST_SYNCS.cg_poll": 60,
                          "CONTACT_WORK.pairs": torch.tensor(5000),
                          "CONTACT_WORK.lanes": torch.tensor(300),
                          "CONTACT_WORK.tris": torch.tensor(70),
                          "CONTACT_WORK.active": torch.tensor(400)})
    base.update(kw)
    return trace.Slice(**base)


def test_contact_readers_by_hand():
    t = _slice()
    assert _reader("contact_narrow_device_ms").read(t) == pytest.approx(0.2)
    assert _reader("contact_broad_device_ms").read(t) == pytest.approx(5.0)
    roof = _reader("contact_narrow_roofline")
    # bytes: 10 narrow phases x 1,024 lanes x 48 B written, 300 lanes x 12
    # B and 70 candidates x 40 B read; operations: 70 candidates x 6,
    # 5,000 pairs x 72 and 400 active pairs x 43
    nbytes = 10 * 1024 * 48 + 300 * 12 + 70 * 40
    assert (roof.FLOPS_PER_TRI, roof.FLOPS_PER_PAIR,
            roof.FLOPS_PER_ACTIVE) == (6, 72, 43)
    flops = 70 * 6 + 5000 * 72 + 400 * 43
    least = max(nbytes / 1e6, flops / 1e9)
    assert least == nbytes / 1e6
    assert roof.read(t) == pytest.approx(100 * least / 0.002)
    flop_bound = _slice(peaks={"hbm_bytes_per_s": 1e12,
                               "fp32_flop_per_s": 1e9})
    assert roof.read(flop_bound) == pytest.approx(100 * flops / 1e9 / 0.002)


def test_contact_readers_report_nothing_without_their_spans_or_counters():
    parent = _slice(counters={"HOST_SYNCS.cg_poll": 60})
    assert _reader("contact_narrow_roofline").read(parent) is None
    three = _slice(counters={f"CONTACT_WORK.{k}": torch.tensor(1)
                             for k in ("pairs", "lanes", "tris")})
    assert _reader("contact_narrow_roofline").read(three) is None
    assert _reader("contact_narrow_device_ms").read(parent) == \
        pytest.approx(0.2)
    assert _reader("contact_narrow_roofline").read(
        _slice(peaks=None)) is None
    free = _slice(program_spans={}, counters={})
    for name in ("contact_narrow_device_ms", "contact_broad_device_ms",
                 "contact_narrow_roofline"):
        assert _reader(name).read(free) is None
    assert _reader("contact_narrow_device_ms").read(_slice(steps=0)) is None
