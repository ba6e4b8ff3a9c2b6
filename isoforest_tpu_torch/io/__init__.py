"""Model files and forest arrays."""
