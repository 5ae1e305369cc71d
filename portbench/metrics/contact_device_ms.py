"""contact_device_ms (ms): device time of the work launched inside the
program's outermost ``zpc.contact.*`` ranges (the broad phase's LBVH
join, the narrow phase's barrier forces and Hessians, the CCD step
bound; a range inside another is not counted twice) per step of the
traced slice."""


def read(t):
    dev_s = t.device_s_under("zpc.contact.")
    if t.steps == 0 or dev_s is None or dev_s <= 0:
        return None
    return 1e3 * dev_s / t.steps
