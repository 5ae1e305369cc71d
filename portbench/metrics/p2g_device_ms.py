"""p2g_device_ms (ms): device time of the work launched inside the
program's ``zpc.p2g`` ranges (the explicit step's particle-to-grid
scatter of mass and APIC momentum) per step of the traced slice."""


def read(t):
    spans = t.program_spans.get("zpc.p2g")
    if t.steps == 0 or t.cg_iters or spans is None or spans[1] <= 0:
        return None
    return 1e3 * spans[1] / t.steps
