"""Counter-based synthetic data streams."""
