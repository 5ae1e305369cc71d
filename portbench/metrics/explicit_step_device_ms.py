"""explicit_step_device_ms (ms): device time of the work launched inside
the benchmark's step span (``explicit_step_binned2``: stress, P2G, grid
update, G2P, advection) per step of the traced slice."""


def read(t):
    if t.steps == 0 or t.cg_iters or t.span_device_s.get("step", 0.0) <= 0:
        return None
    return 1e3 * t.span_device_s["step"] / t.steps
