"""Plain references of the benchmark's configurations, found by the name a
configuration gives under ``"reference"``.  They import neither the
program under test nor JAX."""
