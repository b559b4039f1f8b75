"""Per-layer metric readers, one file per metric, found by name: read(ctx) -> value or None."""
