"""cg_apply_device_ms (ms): device time of the work launched inside the
program's ``zpc.cg.apply`` ranges (one application of the implicit
system's operator in the CG loop: G2P, the force differential, P2G and,
with contact, the product with the barrier's Hessian) per application in
the traced slice."""


def read(t):
    count, dev_s = t.program_spans.get("zpc.cg.apply", (0, 0.0))
    if count == 0 or dev_s <= 0:
        return None
    return 1e3 * dev_s / count
