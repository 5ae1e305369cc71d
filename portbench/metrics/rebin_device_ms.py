"""rebin_device_ms (ms): device time of the work launched inside the
benchmark's rebin span (``rebin_adaptive``: the key sort and the scan
kernel's prefix sums, the table rebuild) per rebin of the traced
slice."""


def read(t):
    if t.rebins == 0 or t.span_device_s.get("rebin", 0.0) <= 0:
        return None
    return 1e3 * t.span_device_s["rebin"] / t.rebins
