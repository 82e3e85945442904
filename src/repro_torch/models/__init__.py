"""Model assembly for the serving path."""
