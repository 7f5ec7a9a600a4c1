"""Host-side utilities of the port: metric calculators."""
