"""Traffic generation (NumPy and the standard library only)."""
