"""One reader per per-layer metric, named as the metric; ``read(facts)`` returns its value or None."""
