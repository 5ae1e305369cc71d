"""contact_narrow_roofline (%): the least time the narrow phase's work
needs on the card, over the device time under ``zpc.contact.narrow``.

The least time is the larger of the bytes over the card's HBM bandwidth
and the float32 operations over its float32 peak
(:mod:`portbench.harness.peaks`).  The work is read from the program's
counter ``CONTACT_WORK`` over the slice (``pairs``: live lanes x
candidate triangles over live bins; ``lanes``: live lanes of bins with a
candidate; ``tris``: candidates of live bins; ``active``: the pairs with
d^2 < dhat^2) and from the slice's shapes, never from how the narrow
phase is written:

* bytes, per narrow phase: every lane's force and Hessian written (3 + 9
  float32, 48 bytes, over all ``shapes["lanes"]`` lanes); then each lane
  in reach read (3 float32, 12 bytes) and each candidate's id and three
  corners read (4 + 36 bytes), summed over the slice's narrow phases;
* operations, counted from the plain reference's formulas
  (``reference/dense_mpm.py``: ``_closest_on_triangle`` and the barrier of
  ``DenseMPM._contact``), one region's closest point as the face's, the
  costliest.  Per candidate, once for its bin: the edges ``ab``, ``ac``
  (6).  Per (lane, candidate) pair, which the closest point and the
  distance must see: ``ap`` (3), ``d1``, ``d2`` (10), ``bp`` and ``d3``,
  ``d4`` (13), ``cp`` and ``d5``, ``d6`` (13), ``va``, ``vb``, ``vc``
  (9), the denominator (2), the two weights (2) and ``a + ab v + ac w``
  (12): 64; ``p - c`` and ``d^2`` (8): 72.  Per active pair, which alone
  the barrier reaches: its two derivatives, ``s - dhat^2``, ``s /
  dhat^2``, the log (3), ``b'`` (6), ``b''`` (10), its clamp (1): 20;
  the accumulation: the force ``2 b' (p - c)`` summed (7), ``4 b''`` (1),
  ``u = 4 b'' (p - c)`` (3), and the Hessian's six distinct products and
  sums (12): 23; 43 in all.

None where the program has no such counter (a tree without it) or the
card has no peak in the table.
"""

OUT_BYTES_PER_LANE = (3 + 9) * 4
LANE_BYTES = 3 * 4
TRI_BYTES = 4 + 9 * 4
FLOPS_PER_TRI = 6
FLOPS_PER_PAIR = 64 + 8
FLOPS_PER_ACTIVE = 20 + 23
KEYS = ("pairs", "lanes", "tris", "active")


def least_seconds(calls: int, lanes_out: int, work: dict,
                  peaks: dict) -> float:
    """The least device seconds of ``calls`` narrow phases over
    ``lanes_out`` lanes each that did ``work`` (pairs, lanes, tris,
    active)."""
    nbytes = (calls * lanes_out * OUT_BYTES_PER_LANE +
              work["lanes"] * LANE_BYTES + work["tris"] * TRI_BYTES)
    flops = (work["tris"] * FLOPS_PER_TRI + work["pairs"] * FLOPS_PER_PAIR +
             work["active"] * FLOPS_PER_ACTIVE)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flop_per_s"])


def read(t):
    work = {k: t.counters.get(f"CONTACT_WORK.{k}") for k in KEYS}
    count, dev_s = t.program_spans.get("zpc.contact.narrow", (0, 0.0))
    if t.peaks is None or any(v is None for v in work.values()) or \
            count == 0 or dev_s <= 0:
        return None
    work = {k: int(v) for k, v in work.items()}
    return 100.0 * least_seconds(count, t.shapes["lanes"], work,
                                 t.peaks) / dev_s
