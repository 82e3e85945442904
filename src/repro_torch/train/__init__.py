"""The UNIQ training step."""
