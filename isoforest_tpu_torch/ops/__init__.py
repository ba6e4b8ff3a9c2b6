"""Scoring kernels and their tables."""
