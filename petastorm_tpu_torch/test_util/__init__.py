"""Helpers for the package's tests."""
