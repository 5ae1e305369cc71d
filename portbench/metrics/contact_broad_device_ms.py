"""contact_broad_device_ms (ms): device time of the work launched inside
the program's ``zpc.contact.broad`` ranges (one dhat-padded box query a
bin through the banded LBVH join, and the candidate lists' extraction)
per step of the traced slice."""


def read(t):
    count, dev_s = t.program_spans.get("zpc.contact.broad", (0, 0.0))
    if t.steps == 0 or count == 0 or dev_s <= 0:
        return None
    return 1e3 * dev_s / t.steps
