"""device_idle_share (%): the share of the traced slice's wall time in
which no operation ran on the device, 1 - busy / wall, busy being the
union of the device activity intervals of the profiler's trace."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
