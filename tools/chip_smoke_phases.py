"""chip_smoke's phases of the adaptive grid, the I/O tooling and the
multi-device steps alone, on one card: environment and build (phases 1-2),
the README scene through simulate (21, whose analytic ground phase 36b
compares against), then phases 36b, 36a, 37 and 38 with their gates
(chip_smoke runs 36b beside phase 23's CPU worker; here the card has the
host to itself).  About 2 minutes against chip_smoke's ~19.

Run from the repository root:  python3 tools/chip_smoke_phases.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import zpc_tpu_torch  # noqa: E402


def main():
    card = cs.environment()
    dev = zpc_tpu_torch.cuda_device(0)
    cs.build()
    with tempfile.TemporaryDirectory() as tmp:
        rsim, rst, rdt, _, rout, rms = cs.readme_path(dev, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        lb, ag = cs.adaptive_ground_path(dev, card, rsim, rst, rdt, rout,
                                         rms)
        la = cs.adaptive_grid_path(dev, card)
        io_l, bsim, bst, bdt, bout = cs.io_path(dev, card, ag, tmp)
        md = cs.multi_device_path(dev, card, bsim, bst, bdt, bout, tmp)
    print(f"  scan launches: 36a {la}, 36b {lb}, 37 {io_l}, 38 {md}",
          flush=True)
    cs.phase("done")


if __name__ == "__main__":
    main()
