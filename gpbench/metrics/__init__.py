"""Per per-layer metric: its reader, `read(ctx)` -> the value, or None
where the run has nothing to read."""
