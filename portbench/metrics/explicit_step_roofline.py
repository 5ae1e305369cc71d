"""explicit_step_roofline (%): the least time the explicit step's work
needs on the card, over ``explicit_step_device_ms``.

The least time is the larger of the bytes over the card's HBM bandwidth
and the float32 operations over its float32 peak
(:mod:`portbench.harness.peaks`).  The count depends on the cell's shapes
only, never on how the step is written (torch ops or hand kernels):

* bytes: each particle's 26 float32 columns (x, v, F, C, m, vol) read
  once and written once; the grid's mass and momentum (4 floats a node)
  written once and its velocity (3 floats) read once, over the 64 nodes
  of each 4^3 block the particles' stencils touch;
* operations, per particle: the FixedCorotated Kirchhoff stress with a
  4-iteration Newton polar (:data:`STRESS_FLOPS`), the quadratic weights
  (3 axes x 3 nodes x 4), the 27 stencil weights (2 products each), the
  APIC affine term A = m C - k tau (18 + 9), P2G per node (w m: 1;
  w (m v + A dx_ip): 3 x 7), G2P per node (w v: 3; sums: 3; the outer
  product into C: 18), F <- (I + dt C) F (45 + 9) and x, v (6); the grid
  update per node (3 divides, 3 adds of gravity, the two colliders' tests
  and selects: 12).
"""

PARTICLE_BYTES = 26 * 4 * 2
NODE_BYTES = (4 + 3) * 4
STRESS_FLOPS = 4 * (27 + 5 + 1 + 18 + 18) + 9 * 4 + 45
PARTICLE_FLOPS = (STRESS_FLOPS + 36 + 27 * 2 + 27 + 27 * (1 + 21) +
                  27 * (3 + 3 + 18) + 54 + 6)
NODE_FLOPS = 12


def step_bytes(shapes: dict) -> float:
    return (shapes["particles"] * PARTICLE_BYTES +
            shapes["touched_blocks"] * 64 * NODE_BYTES)


def step_flops(shapes: dict) -> float:
    return (shapes["particles"] * PARTICLE_FLOPS +
            shapes["touched_blocks"] * 64 * NODE_FLOPS)


def least_seconds(shapes: dict, peaks: dict) -> float:
    return max(step_bytes(shapes) / peaks["hbm_bytes_per_s"],
               step_flops(shapes) / peaks["fp32_flop_per_s"])


def read(t):
    if t.peaks is None or t.steps == 0 or t.cg_iters or \
            t.span_device_s.get("step", 0.0) <= 0:
        return None
    per_step = t.span_device_s["step"] / t.steps
    return 100.0 * least_seconds(t.shapes, t.peaks) / per_step
