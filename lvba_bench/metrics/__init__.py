"""Per-metric readers: each module read(rec) -> float or None."""
