"""Device-time profile of one of the port's paths on one NVIDIA GPU.

Run from the repository root:

    python3 tools/profile_torch_step.py                     # elastic block
    python3 tools/profile_torch_step.py --scene dam_break   # dam break
    python3 tools/profile_torch_step.py --scene implicit    # implicit block
    python3 tools/profile_torch_step.py --scene contact     # + mesh contact
    python3 tools/profile_torch_step.py --scene cloth       # two-layer cloth

``block`` (the default) builds the 262,144-particle elastic block
(dx = 1/128) with BinnedConfig2(bins_capacity=2560, block_capacity=2048);
``dam_break`` the 262,144-particle dam break of bench_fluid with its bins
derived from n, advanced 100 steps past the release; ``implicit`` the
1,000,000-particle implicit block of bench_implicit (chip_smoke phase 13:
dt 5e-4, cg_iters 50, cg_tol 1e-3); ``contact`` the same block over
chip_smoke phase 16's floor (two triangles at y = 0.57 spanning [0, 1]^2,
MeshContact dhat 0.01, kappa 10, max_tris 8).  Each warms up, then traces
10 steps (3 for ``implicit`` and ``contact``) and one rebin_adaptive with
torch.profiler.  Prints
the card's name and power limit, the wall time of the window, the
device's busy time in it (the union of its activity, reduced by
``portbench/harness/trace.py:reduce_profile`` as the benchmark reduces
its traced slice) and so its busy share, and the ops with the most device
time (each op's own kernels); the full table goes to
chiprun_out/profile_torch_step_<scene>.txt.  ``tools/cell_spans.py``
splits a benchmark cell's slice by the program's own spans.

For ``contact`` it also times the contact's parts on the binned state
(CUDA events, mean of 5): the context, the broad phase, the narrow
phase's forces and Hessians, one ``dt^2 H_c s0`` product of an operator
application, and the 32-iteration CCD that ``use_ccd`` adds.

``cloth`` is chip_smoke phase 29's two-layer cloth at 8,192 vertices
(``scenes.cloth_two_layer(64)``: Newton 2 x CG 24, max_cand 32, the
window step with radius 1 and max_residue 65,536), settled by 16 window
steps; it traces 2 steps (no rebin) and times the step's parts by CUDA
events (mean of 5): the candidate set, the window residue, the
gradient, the operator's assembly, one application, and the window's
CCD limiter.

For ``implicit`` it also times three ways to apply the force
differential at the step's F: ``torch.func.linearize`` of the stress (its
trace, then one application), one ``dP_dF_action`` (``torch.func.jvp``
through the SVD), and the model's ``linearize`` (the SVD once, then
``torch.func.jvp`` of the stress around it), which the step uses.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import zpc_tpu_torch  # noqa: E402
from portbench.harness.trace import reduce_profile  # noqa: E402
from zpc_tpu_torch import scenes  # noqa: E402
from zpc_tpu_torch.math.svd import svd3x3  # noqa: E402
from zpc_tpu_torch.ops import implicit_apply  # noqa: E402
from zpc_tpu_torch.sim import fluid_binned2 as fb  # noqa: E402
from zpc_tpu_torch.sim import implicit_binned2 as ib2  # noqa: E402
from zpc_tpu_torch.sim import mpm_binned2 as b2  # noqa: E402

N, DX, STEPS, FLUID_WARM = 262_144, 1.0 / 128, 10, 100
N_IMP, IMP_STEPS = 1_000_000, 3
CLOTH_NX, CLOTH_SETTLE, CLOTH_STEPS = 64, 16, 2


def _block(dev):
    """(step, rebin, binned state) of the elastic block."""
    cfg = b2.BinnedConfig2(bins_capacity=2560, block_capacity=2048)
    sim, st, dt = scenes.mpm_block(N, DX, dev)
    return (lambda s: b2.explicit_step_binned2(sim, s, dt, cfg, rebin=False),
            lambda s: b2.rebin_adaptive(sim, s, cfg),
            b2.bin_state(sim, st, cfg))


def _dam_break(dev):
    """(step, rebin, binned state 100 steps into the collapse) of the dam
    break."""
    sim, st, dt, cfg = scenes.dam_break(N, dev)

    def step(s):
        return fb.explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False)

    def rebin(s):
        return b2.rebin_adaptive(sim, s, cfg)
    bst = b2.adaptive_chain(step, rebin, fb.bin_fluid_state(sim, st, cfg),
                            FLUID_WARM)
    return step, rebin, bst


def _implicit(dev):
    """(step, rebin, binned state) of the implicit block."""
    sim, st, dt = scenes.implicit_block(N_IMP, dev)
    cfg = scenes.implicit_config(N_IMP)
    bst = b2.bin_state(sim, st, cfg)
    _linearize_or_jvp(sim, bst, dt)
    return (lambda s: ib2.implicit_step_binned2(sim, s, dt, cfg,
                                                rebin=False),
            lambda s: b2.rebin_adaptive(sim, s, cfg), bst)


def _contact(dev):
    """(step, rebin, binned state) of the implicit block over the floor."""
    sim, st, dt, cfg, mc = scenes.contact_block(
        N_IMP, scenes.floor_mesh(0.57, 0.0, 1.0, dev), dev)
    bst = b2.bin_state(sim, st, cfg)
    _contact_parts(mc, bst, cfg, dt)
    return (lambda s: ib2.implicit_step_binned2(sim, s, dt, cfg, contact=mc,
                                                rebin=False),
            lambda s: b2.rebin_adaptive(sim, s, cfg), bst)


def _cloth(dev):
    """(step, no rebin, (x, v)) of the two-layer cloth, settled."""
    from zpc_tpu_torch.sim import cloth
    sim, x = scenes.cloth_two_layer(CLOTH_NX, dev)
    cw = cloth.ContactWindow(radius=1, max_residue=65_536)

    def step(c):
        return cloth.implicit_step(sim, c[0], c[1], 0.005, newton_iters=2,
                                   cg_iters=24, self_contact=True,
                                   max_cand=32, contact_window=cw)[:2]
    c = (x, torch.zeros_like(x))
    for _ in range(CLOTH_SETTLE):
        c = step(c)
    x = c[0]
    cand, _ = cloth.self_contact_candidates(sim, x, 32)
    res = cloth.classify_window_residue(sim, cw, cand)[:3]
    op = cloth.assemble_operator(sim, x, x, 0.005, window=cw, window_res=res)
    p = torch.randn_like(x)

    def grad():
        z = x.detach().requires_grad_(True)
        e = (cloth.cloth_energy(sim, z)
             + cloth.window_contact_energy(sim, cw, z)
             + cloth._pair_contact_energy(sim, z, *res))
        return torch.autograd.grad(e, z)[0]
    parts = {
        "candidate set": lambda: cloth.self_contact_candidates(sim, x, 32),
        "window residue": lambda: cloth.classify_window_residue(sim, cw,
                                                               cand),
        "gradient": grad,
        "assembly": lambda: cloth.assemble_operator(
            sim, x, x, 0.005, window=cw, window_res=res),
        "one application": lambda: cloth.apply_operator(sim, op, p, 0.005),
        "window CCD limiter": lambda: cloth._window_ccd_alpha(sim, cw, x,
                                                              0.01 * p),
    }
    for name, fn in parts.items():
        print(f"  {name}: {_events_ms(fn):.4f} ms", flush=True)
    return step, None, c


def _contact_parts(mc, bst, cfg, dt):
    """The contact's parts on ``bst``, each timed alone."""
    B, K = cfg.bins_capacity, b2.K
    ctx = b2._make_ctx(bst, cfg)
    alive = ctx.alive.view(B, K)
    xb = bst.cols[:, 0:3].view(B, K, 3)
    disp = (dt * bst.cols[:, 3:6]).view(B, K, 3)
    cset = mc.broad_phase(ctx, alive)
    _, Hc = mc.forces_and_hessians(cset, xb, alive)
    Hc = Hc.view(-1, 3, 3)
    s0 = bst.cols[:, 3:6]
    parts = {
        "context (_make_ctx)": lambda: b2._make_ctx(bst, cfg),
        "broad phase": lambda: mc.broad_phase(ctx, alive),
        "forces and Hessians": lambda: mc.forces_and_hessians(cset, xb,
                                                              alive),
        "dt^2 H_c s0 (one operator application)":
            lambda: (dt * dt) * torch.bmm(Hc, s0[..., None])[..., 0],
        "CCD toi (use_ccd, 32 iterations)":
            lambda: mc.toi(cset, xb, disp, alive)}
    print(f"contact parts at {B * K} lanes x {mc.max_tris} slots, "
          f"{int(alive.any(1).sum())} live bins (mean of 5): " + "; ".join(
              f"{k} {_events_ms(f):.4f} ms" for k, f in parts.items()),
          flush=True)


def _events_ms(fn, reps=5):
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _linearize_or_jvp(sim, bst, dt):
    """The force differential at the binned state's F, four ways."""
    L = bst.cols.shape[0]
    F = bst.cols[:, 6:15].reshape(L, 3, 3)
    gen = torch.Generator(device=F.device).manual_seed(0)
    dF = dt * torch.randn(L, 3, 3, generator=gen, device=F.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lin = torch.func.linearize(sim.model.first_piola, F)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    lin_ms = _events_ms(lambda: lin(dF))
    jvp_ms = _events_ms(lambda: sim.model.dP_dF_action(F, dF))
    step_lin = sim.model.linearize(F)
    once_ms = _events_ms(lambda: sim.model.linearize(F))
    apply_ms = _events_ms(lambda: step_lin(dF))
    factors = svd3x3(F)
    closed_ms = _events_ms(lambda: implicit_apply.corotated_dP(
        F, factors, dF, sim.model.mu, sim.model.lam))
    want = sim.model.dP_dF_action(F, dF)
    err = max((lin(dF) - want).abs().max().item(),
              (step_lin(dF) - want).abs().max().item(),
              (implicit_apply.corotated_dP(F, factors, dF, sim.model.mu,
                                           sim.model.lam) - want).abs().max(
                  ).item())
    print(f"force differential over {L} lanes: torch.func.linearize trace "
          f"{trace_s:.4f} s, then {lin_ms:.4f} ms an application; "
          f"torch.func.jvp (dP_dF_action) {jvp_ms:.4f} ms an application; "
          f"the model's linearize (the SVD once) {once_ms:.4f} ms, then "
          f"{apply_ms:.4f} ms an application, which the step uses for a "
          f"model other than FixedCorotated; FixedCorotated's closed form "
          f"(ops/implicit_apply.corotated_dP, in plain PyTorch; the step "
          f"runs it inside the operator kernel) {closed_ms:.4f} ms (mean of "
          f"5; the four differ by {err:.3g})", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("block", "dam_break", "implicit",
                                        "contact", "cloth"), default="block")
    scene = ap.parse_args().scene
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = zpc_tpu_torch.cuda_device(0)
    step, rebin, bst = {"block": _block, "dam_break": _dam_break,
                        "implicit": _implicit, "contact": _contact,
                        "cloth": _cloth}[scene](dev)
    steps = {"implicit": IMP_STEPS, "contact": IMP_STEPS,
             "cloth": CLOTH_STEPS}.get(scene, STEPS)

    def window(s):
        for _ in range(steps):
            s = step(s)
            if rebin is not None:
                bool(s.needs_rebin)
        return s if rebin is None else rebin(s)

    window(bst)                                  # warm-up and build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(bst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, _, _, _ = reduce_profile(prof.events())
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time: time with "
                           "CUDA events instead")
    ev = prof.key_averages()
    # each host op's self device time is that of the kernels it launched
    ops = [e for e in ev if e.device_type == DeviceType.CPU]
    print(f"{scene}: {steps} steps{'' if rebin is None else ' + 1 rebin'}: "
          f"wall {wall * 1e3:.4f} ms, device busy {busy * 1e3:.4f} ms, "
          f"busy share {busy / wall:.4f} ({card})", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        if e.self_device_time_total <= 0:
            break
        print(f"  {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.4f} ms"
              f" {100 * e.self_device_time_total * 1e-6 / busy:6.2f}%"
              f" x{e.count}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"profile_torch_step_{scene}.txt"), "w") as f:
        f.write(card + "\n")
        f.write(ev.table(sort_by="self_device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
