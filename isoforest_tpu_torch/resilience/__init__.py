"""Integrity of model directories on disk."""
