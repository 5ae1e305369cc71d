"""cg_iters_per_step (iters/step): mean CG iterations per implicit step
over the traced slice, as ``implicit_step_binned2(with_stats=True)``
reports them."""


def read(t):
    if not t.cg_iters:
        return None
    return sum(t.cg_iters) / len(t.cg_iters)
