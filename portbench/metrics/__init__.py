"""Per-layer metric readers: `metrics/<name>.py` holds `read(t)`, which
takes a `core.trace.TraceSummary` and returns the metric's value, or None
where the traced window has nothing to read."""
