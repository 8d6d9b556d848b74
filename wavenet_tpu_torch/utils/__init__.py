"""Numpy weight interchange."""
