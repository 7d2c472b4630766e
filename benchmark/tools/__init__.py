"""Tools that drive the benchmark: the control."""
