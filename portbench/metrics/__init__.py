"""Per-layer metric readers, one file per metric named in
``BENCHMARK.json``'s ``per_layer``.  Each defines ``read(slice)``, taking
a :class:`portbench.harness.trace.Slice`, and returns the metric's value,
or None when the slice has nothing to read (the harness then leaves the
metric out of the result line)."""
