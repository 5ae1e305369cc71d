"""contact_narrow_device_ms (ms): device time of the work launched inside
the program's ``zpc.contact.narrow`` ranges (the barrier's forces and
Hessians of every live lane against its bin's candidate triangles) per
step of the traced slice."""


def read(t):
    count, dev_s = t.program_spans.get("zpc.contact.narrow", (0, 0.0))
    if t.steps == 0 or count == 0 or dev_s <= 0:
        return None
    return 1e3 * dev_s / t.steps
