"""One file a per-layer metric, named as the metric: ``read(ctx)`` returns
its value from ``benchmark.trace.Context``, or None when the window gave it
nothing to read (the harness then leaves it out of the result line)."""
