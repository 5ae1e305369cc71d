"""Module-level ``jax.jit`` for the port's test files.

A test file compiles a JAX reference once, as one program, by declaring it
at module level with this decorator, its scene (sim, config, dt, arrays)
as arguments and its options as ``static_argnames``; its tests then share
the compile.  The jit is built on the first call, because these files are
also imported where JAX is absent (their cuda tests run on the card's
machine with ``--noconftest``).
"""

import functools


def jit(fn=None, **kw):
    """``jax.jit(fn, **kw)``, built on the first call."""
    if fn is None:
        return functools.partial(jit, **kw)
    compiled = None

    @functools.wraps(fn)
    def call(*args, **kwargs):
        nonlocal compiled
        if compiled is None:
            import jax
            compiled = jax.jit(fn, **kw)
        return compiled(*args, **kwargs)
    return call
