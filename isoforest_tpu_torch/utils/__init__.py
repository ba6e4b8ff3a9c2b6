"""Numeric primitives, params and input checks."""
