"""The comparison that decides ``correct``: the program's particles (x, v,
F) at the end of a segment against the plain reference's after the same
steps from the same inputs.

Three widest gaps, each over every particle:

* ``x_gap_cells``: max |x - x_ref| in grid cells (dx);
* ``v_gap_rel``: max |v - v_ref| over max |v_ref|;
* ``F_gap``: max |F - F_ref| (F is dimensionless).

Every segment of a window starts from the same state, so the reference
runs once.  The window keeps the first segment's particles and, for each
later one, the widest gap to them; a segment's gap to the reference is
bounded by the first's plus that, and the bound is what is compared.
A gap is taken over the entries where it is finite, and the entries
where it is not are counted (``nonfinite``, compared against 0).  A
cell's limits file names the gaps it compares, each with its limit and
the two readings it was set from; the others are printed, not
compared.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

__all__ = ["NAMES", "Tracker", "gaps", "judge"]

NAMES = ("x_gap_cells", "v_gap_rel", "F_gap")


def _gap(a: torch.Tensor, b: torch.Tensor):
    """(widest |a - b| over the entries where it is finite, the number of
    entries where it is not)."""
    d = (a.double() - b.double()).abs()
    fin = torch.isfinite(d)
    return torch.where(fin, d, 0.0).max(), (~fin).sum()


class Tracker:
    """The first segment's particles and every later segment's widest
    gaps to them, kept on the device (no host read in the window).  A
    later segment's value that is not finite has already failed it."""

    def __init__(self):
        self.first = None
        self.delta = None

    def add(self, xvF: Sequence[torch.Tensor]) -> None:
        if self.first is None:
            self.first = tuple(t.clone() for t in xvF)
            self.delta = [torch.zeros((), dtype=torch.float64,
                                      device=t.device) for t in xvF]
            return
        for i, (a, b) in enumerate(zip(xvF, self.first)):
            self.delta[i] = torch.maximum(self.delta[i], _gap(a, b)[0])


def gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
         dx: float, delta: Optional[Sequence[torch.Tensor]] = None
         ) -> Dict[str, float]:
    """The three gaps of ``prog`` (x, v, F) to ``ref`` (x, v, F), plus
    ``delta`` (the segments' widest gaps to ``prog``) when given, and
    ``nonfinite``: the entries where a gap is not finite."""
    pairs = [_gap(a, b) for a, b in zip(prog, ref)]
    d = [g for g, _ in pairs]
    if delta is not None:
        d = [a + b for a, b in zip(d, delta)]
    vmax = ref[1].double().abs().max().clamp_min(1e-30)
    vals = (d[0] / dx, d[1] / vmax, d[2])
    out = {k: float(v) for k, v in zip(NAMES, vals)}
    out["nonfinite"] = int(sum(n for _, n in pairs))
    return out


def judge(values: Dict[str, float], limits: dict):
    """(correct, the compared numbers each with its limit): ``nonfinite``
    against 0, and the gaps the cell's limits name."""
    compared = {"nonfinite": {"value": values["nonfinite"], "limit": 0}}
    ok = values["nonfinite"] == 0
    for name, lim in limits["compare"].items():
        v = values[name]
        good = v == v and v <= lim["limit"]
        ok &= good
        compared[name] = {"value": v, "limit": lim["limit"]}
    return ok, compared
