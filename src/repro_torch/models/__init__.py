"""Model code of the port (dense decode in this slice)."""
