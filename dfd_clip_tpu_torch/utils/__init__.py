"""Host-side utilities of the port: metric calculators, logging, the run's
tracker and the completion notice."""
